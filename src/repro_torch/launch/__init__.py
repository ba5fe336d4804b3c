"""Launchers: the qsim simulation CLI and the SimService demo CLI."""
