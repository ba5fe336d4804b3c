"""B9a, ``pack_bitmap_tiles``, on the card: the kernel of ``csrc/pack.cu``
against its plain version ``ref.pack_bitmap_tiles_ref``, bit for bit, on
int32 bits (any nonzero value counts as set) and on bool bits.

The shapes are the main one (2^22 bits), an n that is a multiple of 32 and
not of 128 (a ragged last word row and a ragged last 1,024-element round of
the kernel, through its C entry, which takes any multiple of 32: the
wrapper takes whole 128-lane rows), small ones, and bits off the 16-byte
boundary (the kernel's unaligned chunk loads).  Every test here needs a
card and skips without one; the CPU path is the plain version itself."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref

CASES = [(1 << 22, "int32", 0), (1 << 22, "bool", 0),
         ((1 << 22) + 96, "int32", 0), ((1 << 22) + 96, "bool", 0),
         (32, "int32", 0), (1056, "bool", 0), (4224, "int32", 1),
         (4256, "bool", 3), (1 << 22, "bool", 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _plain(bits: torch.Tensor) -> torch.Tensor:
    """The plain version on n bits: zeros to a whole 128-lane row, then the
    first n / 32 words."""
    n = bits.numel()
    rows = bits.view(-1, 128) if n % 128 == 0 else torch.cat([
        bits, bits.new_zeros(-n % 128)]).view(-1, 128)
    return ref.pack_bitmap_tiles_ref(rows).view(-1)[:n // 32]


def _kernel(bits: torch.Tensor) -> torch.Tensor:
    n = bits.numel()
    if n % 128 == 0:
        return tpack.pack_bitmap_tiles(bits.view(-1, 128)).view(-1)
    words = torch.empty(n // 32, dtype=torch.int32, device=bits.device)
    tpack._launch("pack_bitmap_tiles", bits.device, bits.data_ptr(),
                  bits.element_size(), words.data_ptr(), n)
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,offset", CASES)
def test_cuda_pack_bitmap_is_bit_equal_to_its_plain_version(
        cuda_device, n, dtype, offset):
    rng = np.random.default_rng(n + offset)
    raw = torch.from_numpy(rng.integers(-1, 2, n + offset).astype(np.int32))
    bits = (raw if dtype == "int32" else raw != 0).to(cuda_device)[offset:]
    assert (bits.data_ptr() % 16 == 0) == (offset == 0)
    before = tpack.launch_counts["pack_bitmap_tiles"]
    got = _kernel(bits)
    torch.cuda.synchronize()
    assert tpack.launch_counts["pack_bitmap_tiles"] == before + 1
    assert torch.equal(got, _plain(bits))


@pytest.mark.cuda
def test_cuda_pack_bitmap_writes_nothing_past_its_words(cuda_device):
    """A ragged n's last word is the last one written: the words after it
    in the allocation keep their fill."""
    n = 4096 + 32
    bits = torch.ones(n, dtype=torch.int32, device=cuda_device)
    words = torch.full((n // 32 + 64,), 7, dtype=torch.int32,
                       device=cuda_device)
    tpack._launch("pack_bitmap_tiles", cuda_device, bits.data_ptr(), 4,
                  words.data_ptr(), n)
    torch.cuda.synchronize()
    assert bool((words[:n // 32] == -1).all())
    assert bool((words[n // 32:] == 7).all())
