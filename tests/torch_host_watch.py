"""A watch for host syncs and host copies in what a CUDA graph would hold,
run on the CPU: the port's tests (``test_torch_graphs.py``, and the
sharded ranks of ``test_torch_parallel.py``, which import no JAX) run a
step's ops under it with ``ops.graphs.capturing`` patched true."""

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops import shading

# ops that read a device value back to the host or size their output by it
SYNCING = {"aten::_local_scalar_dense", "aten::bincount", "aten::nonzero",
           "aten::masked_select", "aten::_unique2", "aten::unique_dim",
           "aten::unique_consecutive", "aten::repeat_interleave.Tensor"}
# tensors made from host data: torch.tensor / as_tensor of Python values
FROM_HOST_OPS = {"aten::lift_fresh", "aten::lift_fresh_copy"}
FROM_HOST_FUNCTIONS = {torch.tensor, torch.as_tensor, torch.from_numpy, torch.asarray}
MOVING = {torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.cpu, torch.Tensor.copy_}


class _Watch(TorchDispatchMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _paused[0]:
            packet = func.overloadpacket._qualified_op_name
            for n in (packet, f"{packet}.{func._overloadname}"):
                if n in SYNCING or n in FROM_HOST_OPS:
                    self.seen.append(n)
            if packet == "aten::segment_reduce" and not (kwargs.get("unsafe") or (
                    len(args) > 6 and args[6])):
                # without unsafe it checks the lengths on the host
                self.seen.append("aten::segment_reduce (lengths checked on the host)")
        return func(*args, **kwargs)


class _WatchCalls(TorchFunctionMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _paused[0]:
            if func in FROM_HOST_FUNCTIONS:
                self.seen.append(f"{func.__name__} (host data)")
            elif func in MOVING and (len(args) > 1 or "device" in kwargs or
                                     func in (torch.Tensor.cuda, torch.Tensor.cpu)):
                # .to(dtype) stays on the device; a device argument (or a
                # copy_ between tensors) may move host data
                moving = func is not torch.Tensor.to or "device" in kwargs or any(
                    isinstance(a, (str, torch.device)) or (
                        isinstance(a, torch.Tensor) and a.device != args[0].device)
                    for a in args[1:])
                if moving and func is torch.Tensor.copy_:
                    moving = args[1].device != args[0].device
                if moving:
                    self.seen.append(f"{func.__name__} (a move)")
        return func(*args, **kwargs)


_paused = [0]


def _unwatched(fn):
    def call(*args, **kwargs):
        _paused[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _paused[0] -= 1
    return call


@contextlib.contextmanager
def watching(seen):
    """Both watches over the block: what they see is appended to ``seen``."""
    with _WatchCalls(seen), _Watch(seen):
        yield


@contextlib.contextmanager
def plain_unwatched():
    """The kernels' plain versions run unwatched: the card never runs them
    (their binning and masks size outputs on the host).  The wrappers
    around them, and the choice of K7's form, are watched."""
    saved = {name: getattr(rc, name) for name in dir(rc) if name.endswith("_plain")}
    saved_slots = shading.vertex_slots
    try:
        for name, fn in saved.items():
            setattr(rc, name, _unwatched(fn))
        # K4's table (built once per faces tensor, before a capture)
        shading.vertex_slots = _unwatched(rc.vertex_slots)
        yield
    finally:
        for name, fn in saved.items():
            setattr(rc, name, fn)
        shading.vertex_slots = saved_slots
