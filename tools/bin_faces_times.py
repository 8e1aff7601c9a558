#!/usr/bin/env python3
"""Time the port's launch path, K9 (``gather_rows``), K7 (``bin_faces``) and
the steps that run them, of a checkout of the port on one CUDA card; or
K7's designs beside each other.

    python3 tools/bin_faces_times.py [--root DIR] [--out FILE]
    python3 tools/bin_faces_times.py --designs [--out FILE]

``--root`` names the checkout whose package is imported (default: the one
that holds this script), so that a change and its parent, unpacked under
``tmp/``, can be timed in turns on one card, each in a process of its own
(parent, change, change, parent).  It loads this checkout's
``chip_smoke.py`` as a module for its scenes and measurements, and calls
the package through its wrappers and entry points only; that checkout's
package must have the ``benchmarks`` subpackage (``steps``: the event
median, the profiler's reading, the loss; ``roofline``: the memory rate).
Measured:

- the host µs per call of every kernel wrapper at tiny shapes (so that the
  device keeps up and the host's launch path is what is timed; K7's
  includes its readback), ``chip_smoke.per_call_us``;
- K9 at ``scale`` (D = 9) and ``textured-scale`` (D = 27) in turns with
  ``torch.gather`` (``chip_smoke.turns_row``'s fields: event medians,
  device time and operations per call, bound);
- K7 at ``scale``, ``textured-scale``, ``hires`` and ``hires-lit`` at the
  8x8 tiles: event median, device busy time and operations per call,
  its kernels' own device time;
- K8 over those exact bins at ``scale`` and ``hires`` (XY) and
  ``hires-lit`` (copy, id/depth): event median, device busy time, its
  kernel's own device time;
- the ``bench``, ``scale``, ``textured-scale``, ``hires`` and
  ``hires-lit`` steps, eagerly (``nr.eager()``, which both sides of a
  parent/change pair have): event median, device busy time and
  operations.

``--designs`` builds ``tools/bin_faces_designs.cu`` (``chip_smoke.
tool_library``) and times K7 as its parent had it (``chip_smoke.
parent_bin_design``) and a stable LSD radix sort of the pairs by tile key
(:func:`radix_design`) beside this checkout's K7 at the four binned shapes
and on a crowded tile (``chip_smoke.crowded_fvp``: one bin of ~74K ids
spanning two bitmap windows), all at 8x8 tiles: device ms per call under
the profiler and event medians, in the order shipped, parent, radix,
radix, parent, shipped, each held bit-equal to the plain version.

The last line of the output is one JSON object, also written to FILE when
given.  Without CUDA the script fails.
"""

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGN_ORDER = ("shipped", "parent", "radix")


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module; it imports the
    package that is first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lead_args(rc, fvp, attrs):
    """The one adapter to another checkout's signatures: the leading
    arguments of K7 (``bin_faces``), of the tiled forms (``xy``, ``latch``,
    ``depth``) and of the binned forms (``binned_xy``, ...: functions of
    the bins), with draw_backside.  This checkout's K7 and K8 take the face
    vertices; its parent's took K1's constants, made here beforehand."""
    tiled = dict(xy=(fvp, True), latch=(fvp, attrs, True), depth=(fvp, True))
    if "consts" in inspect.signature(rc.bin_faces).parameters:
        consts = rc.face_setup(fvp, True)
        return dict(tiled, bin_faces=(consts,),
                    binned_xy=lambda bins: (consts, fvp, bins),
                    binned_latch=lambda bins: (consts, fvp, attrs, bins),
                    binned_depth=lambda bins: (consts, bins))
    return dict(tiled, bin_faces=(fvp, True),
                binned_xy=lambda bins: (fvp, True, bins),
                binned_latch=lambda bins: (fvp, attrs, True, bins),
                binned_depth=lambda bins: (fvp, True, bins))


def tiny_calls(cs, dev):
    """name -> a call of each kernel wrapper on tiny inputs on the card."""
    rc = cs.rc
    rng = np.random.RandomState(0)
    fv = rng.uniform(-1, 1, (1, 9, 3, 3)).astype(np.float32)
    fv[..., 2] = np.abs(fv[..., 2]) + 0.1
    fvp = torch.tensor(np.ascontiguousarray(fv.transpose(0, 3, 2, 1)), device=dev)
    attrs = torch.ones((1, 9, 4), device=dev)
    lead = lead_args(rc, fvp, attrs)
    faces = torch.tensor(cs.icosphere(0)[1], device=dev)
    fim = torch.tensor(rng.randint(-1, 9, (1, 8, 8)).astype(np.int32), device=dev)
    ids = fim.reshape(1, 64)
    bins = rc.bin_faces(*lead["bin_faces"], 16)
    g6, g12 = torch.ones((1, 6, 8, 8), device=dev), torch.ones((1, 12, 64), device=dev)
    g9, table3 = torch.ones((1, 3, 3, 20), device=dev), torch.ones((1, 12, 3), device=dev)
    table9 = torch.ones((1, 9, 5), device=dev)
    return {
        "face_setup": lambda: rc.face_setup(fvp, True),
        "resolve_xy": lambda: rc.resolve_xy(*lead["xy"], 16, 0.1, 100.0),
        "resolve_latch": lambda: rc.resolve_latch(*lead["latch"], 16, 0.1, 100.0),
        "resolve_depth": lambda: rc.resolve_depth(*lead["depth"], 16, 0.1, 100.0),
        "scatter_pixels_to_faces": lambda: rc.scatter_pixels_to_faces(g6, fim, 9),
        "scatter_faces_to_vertices": lambda: rc.scatter_faces_to_vertices(g9, faces, 12),
        "gather_faces3": lambda: rc.gather_faces3(table3, faces),
        "atlas_taps_grad": lambda: rc.atlas_taps_grad(g12, ids, 3, 9),
        "bin_faces": lambda: rc.bin_faces(*lead["bin_faces"], 16),
        "resolve_binned_xy": lambda: rc.resolve_binned_xy(*lead["binned_xy"](bins), 16, 0.1,
                                                          100.0),
        "resolve_binned_latch": lambda: rc.resolve_binned_latch(*lead["binned_latch"](bins), 16,
                                                                0.1, 100.0),
        "resolve_binned_depth": lambda: rc.resolve_binned_depth(*lead["binned_depth"](bins), 16,
                                                                0.1, 100.0),
        "gather_rows": lambda: rc.gather_rows(table9, ids, True),
    }


class Scenes:
    """The configurations' renderers, meshes and face vertices on the card."""

    def __init__(self, cs, dev):
        nr = cs.nr
        self.cs, self.dev = cs, dev
        tv, tf = cs.torus(40, 32)
        iv, ifc = cs.icosphere(6)
        self.torus_v = torch.tensor(tv[None], device=dev)
        self.torus_f = torch.tensor(tf, device=dev)
        self.sphere_v = torch.tensor(iv[None], device=dev)
        self.sphere_f = torch.tensor(ifc, device=dev)
        self.bench = nr.Renderer(dev)
        self.bench.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
        self.scale = nr.Renderer(dev)
        self.scale.image_size, self.scale.anti_aliasing = 512, False
        self.scale.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
        self.hires = nr.Renderer(dev)
        self.hires.image_size = 1024
        self.hires.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
        self.textured = {name: cs.Textured(name, dev) for name in ("textured-scale", "hires-lit")}

    def attrs(self, label):
        """The face attributes a binned configuration latches (none for the
        silhouette ones)."""
        if label in self.textured:
            return self.textured[label].latch_inputs()[3]
        fvp = self.faces(label)[0]
        return fvp.new_empty((fvp.shape[0], fvp.shape[-1], 0))

    def faces(self, label):
        """(face vertices, S) of a binned configuration."""
        cs = self.cs
        with torch.no_grad():
            if label in self.textured:
                cfg = self.textured[label]
                return cfg.latch_inputs()[1], cfg.size
            r = self.scale if label == "scale" else self.hires
            fvp = cs.gather_face_vertices(r.transform_vertices(self.sphere_v), self.sphere_f)
            return fvp, r.image_size * (2 if r.anti_aliasing else 1)

    def steps(self):
        from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import bench_loss

        cs = self.cs
        return {
            "bench": cs.sil_step(self.bench, self.torus_v, self.torus_f, bench_loss),
            "scale": cs.sil_step(self.scale, self.sphere_v, self.sphere_f, cs.pattern_loss),
            "textured-scale": self.textured["textured-scale"].step,
            "hires": cs.sil_step(self.hires, self.sphere_v, self.sphere_f, bench_loss),
            "hires-lit": self.textured["hires-lit"].step,
        }


BINNED = ("scale", "textured-scale", "hires", "hires-lit")


def checkout_rows(cs, dev, gen):
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks.roofline import HBM_BYTES_PER_S
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import median_ms, profile_device

    rc = cs.rc
    out = {"wrapper_host_us": {name: cs.per_call_us(call)
                               for name, call in tiny_calls(cs, dev).items()}}
    scenes = Scenes(cs, dev)
    with torch.no_grad():
        fvp = cs.gather_face_vertices(scenes.scale.transform_vertices(scenes.sphere_v),
                                      scenes.sphere_f)
        scale_map = cs.index_map(scenes.scale, scenes.sphere_v, scenes.sphere_f, False)
        ts = scenes.textured["textured-scale"]
        _, ts_fvp, _, attrs = ts.latch_inputs()
        ts_table = torch.cat([ts_fvp.permute(0, 3, 2, 1).reshape(1, -1, 9), attrs], -1).contiguous()
        gathers = {"scale": cs.gather_rows_check(
                       "scale", fvp.permute(0, 3, 2, 1).reshape(1, -1, 9).contiguous(), scale_map),
                   "textured-scale": cs.gather_rows_check("textured-scale", ts_table, ts.fim())}
        out["gather_rows"] = {label: cs.turns_row(call.kernel, call.library,
                                                  call.bound[0] * HBM_BYTES_PER_S / 1e3)
                              for label, call in gathers.items()}
        out["bin_faces"] = {}
        for label in BINNED:
            fvp, S = scenes.faces(label)
            lead = lead_args(rc, fvp, fvp.new_empty((1, fvp.shape[-1], 0)))["bin_faces"]

            def call(lead=lead, S=S):
                return rc.bin_faces(*lead, S)

            prof = cs.profile_kept(call)
            out["bin_faces"][label] = dict(
                tile=list(rc.BIN_TILE), ms=median_ms(call, 50),
                device_ms=prof.busy,
                device_ops=prof.ops,
                # its kernels' mean records times the calls (two kernels in
                # the parent's K7, three here; one counted launch each call)
                kernel_device_ms=sum(prof.per_launch.values())
                * prof.launched.get("bin_faces", 0.0))
        out["resolve_binned"] = {}
        for label, form in (("scale", "xy"), ("hires", "xy"), ("hires-lit", "latch"),
                            ("hires-lit", "depth")):
            fvp, S = scenes.faces(label)
            lead = lead_args(rc, fvp, scenes.attrs(label))
            bins = rc.bin_faces(*lead["bin_faces"], S)
            kernel = getattr(rc, f"resolve_binned_{form}")

            def call(kernel=kernel, args=lead[f"binned_{form}"](bins), S=S):
                return kernel(*args, S, 0.1, 100.0)

            prof = cs.profile_kept(call)
            out["resolve_binned"][f"{label} {form}"] = dict(
                ms=median_ms(call, 50), device_ms=prof.busy, device_ops=prof.ops,
                kernel_device_ms=sum(prof.per_launch.values()))
    out["steps"] = {}
    for label, step in scenes.steps().items():
        with cs.nr.eager():
            ms = median_ms(step, 20, warmup=3)
            prof = profile_device(step)
        out["steps"][label] = dict(ms=ms, device_busy_ms=prof.busy, device_ops=prof.ops,
                                   every_record_kept=prof.complete)
    return out


def radix_design(cs):
    """K7 as a stable LSD radix sort of the face-major (tile, face) pairs by
    tile key, 8 bits a pass (``bin_faces_plain``'s own algorithm, by hand;
    ``tools/bin_faces_designs.cu``): a function (consts, S, row_start,
    rows) -> (cnt, offsets, ids) of K7's contract at 8x8 tiles."""
    rc = cs.rc
    lib = cs.tool_library("bin_faces_designs")
    P, I = ctypes.c_void_p, ctypes.c_int
    count = cs.typed_entry(lib, "radix_count", (P, P, P, I, I, I, I, I, I, I, I))
    emit = cs.typed_entry(lib, "radix_emit", (P, P, P, P, I, I, I, I, I, I, I))
    sort_pass = cs.typed_entry(lib, "radix_pass", (P, P, P, P, P, P, I, I, I))
    bounds = cs.typed_entry(lib, "radix_bounds", (P, I, P, P, I))

    def i32(shape, dev, fill=None):
        shape = (shape,) if isinstance(shape, int) else shape
        return torch.empty(shape, dtype=torch.int32, device=dev) if fill is None else \
            torch.full(shape, fill, dtype=torch.int32, device=dev)

    def radix(consts, S, r0, rows):
        bs, _, nf = consts.shape
        (th, tw), dev = rc.BIN_TILE, consts.device
        n_tiles = -(-S // tw) * -(-rows // th)
        padded = lambda k: max(1, -(-k // rc.BIN_SCAN_TILE)) * rc.BIN_SCAN_TILE  # noqa: E731
        first, total = i32(padded(bs * nf), dev, 0), i32(1, dev)
        count(consts.data_ptr(), first.data_ptr(), total.data_ptr(), bs, nf, S, r0, rows, th, tw,
              len(first))
        n = int(total)                                               # the host sync
        keys, vals, keys2, vals2 = (i32(n, dev) for _ in range(4))
        emit(consts.data_ptr(), first.data_ptr(), keys.data_ptr(), vals.data_ptr(), bs, nf, S, r0,
             rows, th, tw)
        hist = i32(padded(256 * -(-n // 2048)), dev, 0)
        for shift in range(0, max(1, (bs * n_tiles - 1).bit_length()), 8):
            sort_pass(keys.data_ptr(), vals.data_ptr(), keys2.data_ptr(), vals2.data_ptr(),
                      hist.data_ptr(), total.data_ptr(), n, shift, len(hist))
            keys, vals, keys2, vals2 = keys2, vals2, keys, vals
        cnt, offsets = i32((bs, n_tiles), dev), i32((bs, n_tiles), dev)
        bounds(keys.data_ptr(), n, cnt.data_ptr(), offsets.data_ptr(), bs * n_tiles)
        return cnt, offsets, vals

    return radix


def design_rows(cs, dev):
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import median_ms

    rc = cs.rc
    designs = {"parent": cs.parent_bin_design(), "radix": radix_design(cs)}
    scenes = Scenes(cs, dev)
    shapes = {label: scenes.faces(label) for label in BINNED}
    shapes["crowded"] = (cs.crowded_fvp(dev), 512)
    rows = []
    with torch.no_grad():
        for label, (fvp, S) in shapes.items():
            # the designs read K1's constants, made beforehand
            consts = rc.face_setup(fvp, True)
            calls = {"shipped": lambda fvp=fvp, S=S: rc.bin_faces(fvp, True, S)}
            for name, fn in designs.items():
                calls[name] = lambda consts=consts, S=S, fn=fn: fn(consts, S, 0, S)
            want = rc.bin_faces_plain(fvp, True, S)
            exact = {name: all(torch.equal(g, w) for g, w in zip(call(), want))
                     for name, call in calls.items()}
            device_ms = {name: [] for name in calls}
            event_ms = {name: [] for name in calls}
            ops, top = {}, {}
            for name in DESIGN_ORDER + DESIGN_ORDER[::-1]:
                prof = cs.profile_kept(calls[name])
                device_ms[name].append(prof.busy)
                ops[name], top[name] = prof.ops, prof.top
                event_ms[name].append(median_ms(calls[name], 20))
            rows.append(dict(config=label, tile=list(rc.BIN_TILE), nf=consts.shape[-1],
                             pairs=len(want[2]), largest_bin=int(want[0].max()),
                             bit_equal=exact, device_ops=ops, top=top,
                             device_ms={k: float(np.mean(v)) for k, v in device_ms.items()},
                             device_ms_turns=device_ms,
                             ms={k: float(np.mean(v)) for k, v in event_ms.items()},
                             ms_turns=event_ms))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose package is timed")
    parser.add_argument("--designs", action="store_true",
                        help="time K7 beside tools/bin_faces_designs.cu")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bin_faces_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    if not os.path.abspath(cs.nr.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {cs.nr.__file__}, not the package under {root}")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cs.cuda_build.build()
    cs.cuda_build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = dict(root=os.path.relpath(root, HERE), smi=smi, torch=torch.__version__)
    if args.designs:
        result["designs"] = design_rows(cs, dev)
    else:
        result.update(checkout_rows(cs, dev, gen))
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
