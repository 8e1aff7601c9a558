"""The port's packed launch path on the CPU: every kernel's C entry takes a
block of int64 argument slots and the stream (``csrc/nr_entry.cuh``), so a
slot list in ``cuda_build.SIGNATURES`` that disagreed with the typed entry
function would pass garbage to a kernel, which only the card would show.
These tests read the typed functions from the sources and hold the slot
lists to them, and check the block's layout."""

import re
import struct

import pytest

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils import cuda_build

ENTRY = re.compile(r"^NR_PACKED_ENTRY\((\w+)\)$", re.M)


def _typed_functions():
    """name -> the parameter list after the stream of each packed entry's
    typed function, read from csrc/*.cu."""
    out = {}
    for src in cuda_build.sources():
        text = src.read_text()
        for name in ENTRY.findall(text):
            m = re.search(rf"^int {name}\(void\* stream,([^)]*)\)", text, re.M)
            assert m, f"{src.name}: no typed function for NR_PACKED_ENTRY({name})"
            out[name] = [" ".join(p.split()) for p in m.group(1).split(",")]
    return out


def _code(param):
    kind = param.rsplit(" ", 1)[0] if "*" not in param else "*"
    return {"*": "P", "int": "i", "long long": "q", "float": "f"}[kind]


def test_every_entry_is_packed_and_listed():
    assert sorted(_typed_functions()) == sorted(cuda_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_slots_match_the_typed_function(name):
    params = _typed_functions()[name]
    assert "".join(_code(p) for p in params) == cuda_build.SIGNATURES[name], params


def test_block_holds_the_card_then_one_slot_per_argument():
    # resolve_xy: 5 pointers, 5 ints, near and far
    args = (1 << 40, 2, 3, 4, 5, 1, 81920, 512, 0, 512, 0.1, 100.0)
    block = cuda_build.PACKERS["resolve_xy"].pack(3, *args)
    assert len(block) == 8 * (1 + len(args))
    slots = struct.unpack("<13q", block)
    assert slots[:11] == (3, *args[:10])
    # a float is a double's bits, which the entry rounds to float
    assert struct.unpack("<2d", block[-16:]) == (0.1, 100.0)
    with pytest.raises(struct.error):
        cuda_build.PACKERS["resolve_xy"].pack(3, *args[:-1])


def test_only_kernels_are_counted():
    """K7's count entry is no kernel of LAUNCHES: the call counts once, at
    its ``bin_faces`` entry; every other entry is a kernel's."""
    assert set(cuda_build.SIGNATURES) - set(rc.KERNELS) == {"bin_faces_count"}
    assert set(rc.KERNELS) <= set(cuda_build.SIGNATURES)
