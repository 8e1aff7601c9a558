"""The port's headline bench (the counterpart of the repository's
``bench.py``): pixels/s of one batch-1 silhouette optimisation step at
256^2 with anti-aliasing (the resolve at 512^2), forward + backward +
update, on one CUDA card.

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.bench

The step is ``bench.py``'s: ``look_at`` + ``perspective(angle=30)`` from
``get_points_from_angles(2.732, 30, 0)``, ``rasterize_silhouettes``, the
loss ``sum(i^2) / (sum(i) + 1)`` and the update ``v -= 1e-6 * grad``.  The
mesh is the OBJ at ``NR_BENCH_OBJ`` if set, else the ``torus(40, 32)`` OBJ
that ``scenes.write_example_data`` writes (2,560 faces, for the reference
teapot's 2,464), through ``load_obj``.  ``NR_BENCH_IMAGE_SIZE`` (256),
``NR_BENCH_BATCH`` (1) and ``NR_BENCH_ITERS`` (200) as in ``bench.py``.

The step is captured whole by its caller in one CUDA graph, as ``bench.py``
jits it; ``NR_BENCH_ITERS`` and twice as many replays, each feeding the
next, are timed by CUDA events and differenced (``steps.chained_ms``), six
cycles; ``value`` comes from their median.  The host's time to enqueue a
replay is printed beside it: where it nears the step, the host's graph
launches set the chain's pace.  Before timing, the chained
step's images must equal the eager step's and its gradients lie within
1e-4 of them, or the bench fails.  It also times the eager and
graphed-core forms (``steps.time_forms``: in turns, each the median of 20
steps after 3 warm-up; ``forms["per_step"]`` holds each form's turns,
device busy share and operations, the whole step's unchained).

The last line is one JSON object with ``bench.py``'s keys (``metric``,
``value`` in pixels/s, ``unit``, ``vs_baseline``) and ``device``,
``power_limit``, ``forms`` and ``faces``.  ``vs_baseline`` divides by
``BENCH_BASELINE.json`` beside this module (a chip run's figure, with its
card and power limit), which the bench reads and never writes; null
without it, or where it timed other faces, image size or batch.  Without a card it prints one line and exits with status 2.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..ops import graphs
from . import steps

METRIC = "pixels/s fwd+bwd 256x256 silhouette (port, torus stand-in for the teapot)"
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_BASELINE.json")
CYCLES = 6


def scene(device, obj=None, image_size=256, batch=1):
    """bench.py's step inputs on ``device`` (``steps.Silhouettes``)."""
    v, f = steps.bench_mesh(obj)
    return steps.Silhouettes(v, f, image_size, batch=batch, device=device)


def baseline(faces, image_size, batch):
    """The committed baseline's value where it timed this workload (its
    faces, image size and batch), else None; None without the file."""
    if not os.path.exists(BASELINE):
        return None
    with open(BASELINE) as fh:
        base = json.load(fh)
    if (base["faces"], base["image_size"], base["batch"]) != (faces, image_size, batch):
        return None
    return float(base["value"])


def run(device, obj=None, image_size=256, batch=1, iters=200, cycles=CYCLES):
    """The checks and the three forms' times; returns the JSON object."""
    name, power_limit = steps.card()
    s = scene(device, obj, image_size, batch)
    case = s.case("bench")
    with graphs.eager():
        want = case.step()
    whole = steps.CallerGraph(case)
    err = steps.check_against("bench chained step", whole(), want)
    timed = steps.time_forms(case, whole)
    forms = {"eager_ms": timed["eager"]["ms"], "core_ms": timed["core"]["ms"]}
    per_step, host = steps.chained_ms(whole, iters, cycles)
    ms = float(np.median(per_step))
    forms.update(whole_ms=ms, whole_best_ms=min(per_step), whole_cycles_ms=per_step,
                 whole_spread=(max(per_step) - min(per_step)) / ms,
                 whole_host_enqueue_ms=float(np.median(host)), cycles=cycles, iters=iters,
                 capture_s=whole.seconds, grad_max_abs_err=err, launches=whole.launches,
                 per_step=timed)
    pixels = batch * image_size * image_size
    value = pixels / ms * 1e3
    faces = int(s.faces.shape[0])
    base = baseline(faces, image_size, batch)
    print(f"[bench] {faces} faces, {batch} x {image_size}^2: chained whole step "
          f"{ms:.6f} ms (median of {cycles} cycles; best {min(per_step):.6f}, spread "
          f"{100 * forms['whole_spread']:.2f}%; the host enqueues a replay in "
          f"{forms['whole_host_enqueue_ms']:.6f}) = {value / 1e6:.3f} Mpx/s; eager "
          f"{forms['eager_ms']:.6f} ms, graphed core {forms['core_ms']:.6f} ms  "
          f"({name}, {power_limit})", flush=True)
    return {"metric": METRIC, "value": value, "unit": "pixels/s",
            "vs_baseline": None if base is None else value / base,
            "device": name, "power_limit": power_limit, "forms": forms,
            "faces": faces}


def main():
    if steps.needs_card("bench"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0"), os.environ.get("NR_BENCH_OBJ"),
                   int(os.environ.get("NR_BENCH_IMAGE_SIZE", "256")),
                   int(os.environ.get("NR_BENCH_BATCH", "1")),
                   int(os.environ.get("NR_BENCH_ITERS", "200"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
