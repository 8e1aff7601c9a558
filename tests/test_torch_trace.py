"""The port's spans and counters (``utils/trace.py``) on the CPU: off by
default, recording nothing and dispatching nothing; on, a silhouette fit's
spans in order with their parents and steps, the backward spans opened
and closed by autograd hooks; a lit RGB render's sampler and lights
spans nested in the maps' spans, and its operations as before they had
spans; K7's counts of capped binnings under ``graphs.forced_capacity``
on the plain versions; and the benchmark's readers of those counts.  The device marks (external CUDA events) and the
counts that K7 adds on the card are held in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.ops import graphs
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.utils import trace
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import torus

FORWARD = ["camera", "camera", "gather", "resolve", "planes", "pool"]
BACKWARD = ["pool.vjp", "nmr.grad", "nmr.grad.y", "nmr.grad.x", "planes.vjp", "resolve.vjp",
            "gather.vjp", "camera.vjp", "camera.vjp"]


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty after it."""
    trace.enable()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def scene():
    v, f = torus(12, 8)
    r = nr.Renderer("cpu")
    r.image_size = 16
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    return r, torch.tensor(v[None]), torch.tensor(f)


def _fit_steps(scene, n, anti_aliasing=True):
    """``n`` steps of a silhouette fit (render, loss, backward, Adam)."""
    r, v, faces = scene
    r.anti_aliasing = anti_aliasing
    x = v.clone().requires_grad_(True)
    adam = nr.Adam([x], lr=0.01)
    for _ in range(n):
        images = r.render_silhouettes(x, faces)
        (images * images).sum().backward()
        adam.step()
        x.grad = None
    r.anti_aliasing = True
    return images


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_tracing_is_off_by_default_and_records_nothing(scene):
    assert trace.span("camera") is trace.span("update", torch.zeros(1))
    trace.clear()
    _fit_steps(scene, 2)
    assert trace.spans() == [] and trace.sample() == [] and trace.device_ms() == {}


@pytest.mark.parametrize("route", ["tiled", "binned"])
def test_spans_dispatch_no_operation(scene, route):
    """A fit step dispatches the same operations, in order, with tracing on
    as off (so a graph captured either way holds the same kernels), and
    gives the same bits."""
    runs = {}
    for on in (False, True):
        if on:
            trace.enable()
        ops = _Ops()
        try:
            with rc.forced_route(route), ops:
                images = _fit_steps(scene, 2)
        finally:
            trace.disable()
        runs[on] = ops.names, images
    trace.clear()
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])


@pytest.mark.parametrize("anti_aliasing", [True, False])
def test_a_fits_spans_in_order_with_parents_and_steps(scene, traced, anti_aliasing):
    """Two steps: each the forward's spans, the backward's, then the
    update, in the order they began; every span's step the Adam count
    before its update; the NMR passes inside ``nmr.grad``, each child
    inside its parent on the host's clock; nothing left open."""
    _fit_steps(scene, 2, anti_aliasing)
    spans = sorted(trace.spans(), key=lambda s: s["start_ns"])
    per_step = FORWARD + BACKWARD + ["update"]
    assert [s["name"] for s in spans] == per_step * 2
    assert [s["step"] for s in spans] == [0] * len(per_step) + [1] * len(per_step)
    by_name = {}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and not s["captured"]
        want = "nmr.grad" if s["name"].startswith("nmr.grad.") else None
        assert s["parent"] == want, s
        by_name.setdefault(s["name"], []).append(s)
    for child in ("nmr.grad.y", "nmr.grad.x"):
        for s, parent in zip(by_name[child], by_name["nmr.grad"]):
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert trace.device_ms() == {}           # no device: no mark


def test_backward_spans_follow_one_another(scene, traced):
    """The hooks close each backward span before the next opens where they
    meet at one tensor: the pool's VJP before the NMR passes, the maps'
    VJP before K3's, K4's before the camera's, perspective's before
    look_at's."""
    _fit_steps(scene, 1)
    spans = sorted((s for s in trace.spans() if s["name"] in BACKWARD
                    and not s["name"].startswith("nmr.grad.")), key=lambda s: s["start_ns"])
    assert [s["name"] for s in spans] == [n for n in BACKWARD if not n.startswith("nmr.grad.")]
    for a, b in zip(spans, spans[1:]):
        assert a["end_ns"] <= b["start_ns"], (a, b)


def test_vjp_closes_once_every_input_has_its_gradient(traced):
    """``trace.vjp`` over two inputs closes at the later one; with no input
    that takes gradients it records nothing; a second backward
    (retain_graph) records the span again."""
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    h = (a * 2).sin()
    out = (h + b * 3).sum()
    trace.vjp("toy", out, [h, b])
    trace.vjp("none", out, [torch.ones(3)])
    out.backward(retain_graph=True)
    out.backward()
    toy = trace.spans("toy")
    assert len(toy) == 2 and not trace.spans("none") and not trace._open
    assert all(s["end_ns"] >= s["start_ns"] for s in toy)


@pytest.mark.parametrize("backward", [True, False])
def test_vjp_hooks_go_with_the_forwards_graph(scene, traced, backward):
    """A fitted leaf keeps the backward spans' hooks of the one forward
    whose graph is alive, not one more a step, with or without a backward;
    once that graph is gone it keeps none, and every span is closed."""
    r, v, faces = scene
    x = v.clone().requires_grad_(True)
    adam = nr.Adam([x], lr=0.01)
    held = []
    for _ in range(4):
        images = r.render_silhouettes(x, faces)
        if backward:
            (images * images).sum().backward()
            adam.step()
            x.grad = None
        held.append(len(x._backward_hooks or {}))
    assert held == [1] * 4
    del images
    assert not x._backward_hooks and not trace._open
    assert len(trace.spans("camera.vjp")) == (8 if backward else 0)


def _lit_step(kind, lit=True):
    """One lit RGB render of a small torus (the loaded-atlas sampler, or
    with ``kind`` "texel" the texel-patch one), its loss and backward, the
    vertices and the atlas taking gradients; every tensor made fresh, so
    K4's slot table is built in the step."""
    from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (atlas_scene,
                                                                   lit_light_arrays,
                                                                   texel_scene)

    if kind == "atlas":
        v, f, vt, ft, tex = atlas_scene(8, 6, 24, 40)
    else:
        v, f, vt, ft, tex = texel_scene(8, 6, 2)
    r = nr.Renderer("cpu")
    r.image_size = 16
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    r.texture_size = 2 if kind == "texel" else None
    kinds = {"directional": nr.DirectionalLight, "ambient": nr.AmbientLight,
             "specular": nr.SpecularLight}
    lights = [kinds[k](**{n: torch.tensor(a) for n, a in fields.items()})
              for k, fields in lit_light_arrays()] if lit else None
    x = torch.tensor(v[None]).requires_grad_(True)
    t = torch.tensor(tex).requires_grad_(True)
    images = r.render_rgb(x, torch.tensor(f), torch.tensor(vt), torch.tensor(ft), t,
                          lights=lights)
    (images * images).sum().backward()
    return images, x.grad, t.grad


@pytest.mark.parametrize("kind", ["atlas", "texel"])
def test_a_lit_render_nests_the_sampler_and_lights_spans(traced, kind):
    """A lit RGB render and its backward: ``sample`` and the per-pixel
    ``lights`` inside ``planes``; ``lights`` of the vertex normals before
    the resolve; their VJPs inside ``planes.vjp``, one after the other,
    K6's ``atlas.vjp`` inside ``sample.vjp`` (the loaded atlas); the
    normals' ``lights.vjp`` after K3's span, before K4's."""
    _lit_step(kind)
    spans = sorted(trace.spans(), key=lambda s: s["start_ns"])
    got = [(s["name"], s["parent"]) for s in spans
           if s["name"] in ("sample", "sample.vjp", "lights", "lights.vjp", "atlas.vjp",
                            "resolve", "resolve.vjp", "gather.vjp")]
    sample_vjp = [("sample.vjp", "planes.vjp")]
    if kind == "atlas":
        sample_vjp.append(("atlas.vjp", "sample.vjp"))
    assert got == [("lights", None), ("resolve", None), ("sample", "planes"),
                   ("lights", "planes"), ("lights.vjp", "planes.vjp"), *sample_vjp,
                   ("resolve.vjp", None), ("lights.vjp", None), ("gather.vjp", None)]
    by_name = {s["name"]: s for s in spans if s["name"] in ("planes", "planes.vjp")}
    inner = [s for s in spans if s["parent"] in ("planes", "planes.vjp")]
    for s in inner:
        parent = by_name[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], s
    lights_vjp, sample_vjp = (next(s for s in inner if s["name"] == n)
                              for n in ("lights.vjp", "sample.vjp"))
    assert lights_vjp["end_ns"] <= sample_vjp["start_ns"]
    assert not trace._open


# the operations other than views (which launch no kernel) that a lit RGB
# step of :func:`_lit_step` dispatched, once a first step had run (what
# the port keeps across steps made), before the sampler and the lights
# had spans; "atlas" since the loaded-atlas sampler became one Function,
# and both since the lights' per-pixel pass became one, whose plain VJPs on
# the CPU recompute the forward (on the card: one kernel each way)
LIT_STEP_KERNEL_OPS = {"atlas": 1775, "texel": 1659}


class _Kernels(TorchDispatchMode):
    """The operations dispatched while on, views left out."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["atlas", "texel"])
def test_a_lit_step_dispatches_what_it_did_before_its_spans(kind):
    """Tracing off, a lit RGB step dispatches the operations other than
    views that it dispatched before the sampler and the lights had spans
    (so a graph captured from it holds the same kernels); on, the same
    operations in the same order, views too, and the same bits."""
    _lit_step(kind)
    runs = {}
    for on in (False, True):
        if on:
            trace.enable()
        ops, kernels = _Ops(), _Kernels()
        try:
            with ops, kernels:
                out = _lit_step(kind)
        finally:
            trace.disable()
        runs[on] = ops.names, kernels.names, out
    trace.clear()
    assert len(runs[False][1]) == LIT_STEP_KERNEL_OPS[kind]
    assert runs[True][:2] == runs[False][:2]
    for a, b in zip(runs[True][2], runs[False][2]):
        assert torch.equal(a, b)


class _Card:
    """A stand-in for a card's timing events: an event is stamped when it
    is recorded, or, while a stand-in graph is captured, at each replay of
    that graph."""

    def __init__(self):
        self.now, self.capturing = 0.0, None

    def mark(self, device, external=True):
        event = _Event()
        if self.capturing is not None and external:
            self.capturing.append(event)
        else:
            event.at = self.tick()
        return event

    def tick(self):
        self.now += 1.0
        return self.now

    def replay(self, graph):
        for event in graph:
            event.at = self.tick()


class _Event:
    at = None

    def elapsed_time(self, end):
        if self.at is None or end.at is None:
            raise RuntimeError("event not recorded")
        return end.at - self.at


def test_sample_reads_each_graph_once_a_replay(traced, monkeypatch):
    """``sample`` reads the spans of the graphs that replayed since the last
    sample, once each: not a graph that was never replayed, replaced or
    left idle since; with ``origin`` each reading's start and end after
    it.  Device ms a step average the readings."""
    card = _Card()
    monkeypatch.setattr(trace, "_mark", card.mark)
    monkeypatch.setattr(trace, "_synchronize", lambda marks: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: card.capturing is not None)
    dev = torch.device("cuda", 0)
    with trace.span("warm-up", dev):
        card.tick()
    graphs = {}
    for name in ("a", "b"):
        card.capturing = graphs[name] = []
        with trace.span(name, dev):
            pass
        card.capturing = None

    def names(readings):
        return sorted(r["name"] for r in readings)

    assert trace.sample() == []
    card.replay(graphs["a"])
    assert names(trace.sample()) == ["a"]
    assert trace.sample() == []
    card.replay(graphs["b"])
    card.replay(graphs["a"])
    assert names(trace.sample()) == ["a", "b"]
    card.replay(graphs["b"])
    assert names(trace.sample()) == ["b"]
    origin = card.mark(dev, external=False)
    card.replay(graphs["a"])
    assert trace.sample(origin) == [dict(name="a", parent=None, ms=1.0, start_ms=1.0,
                                         end_ms=2.0)]
    assert trace.device_ms() == {"warm-up": 2.0, "a": 1.0, "b": 1.0}


def test_update_span_counts_adams_steps(traced):
    x = torch.ones(4, requires_grad=True)
    adam = nr.Adam([x], lr=0.1)
    for k in range(3):
        (x * x).sum().backward()
        with trace.span("work") as work:
            pass
        adam.step()
        assert work["step"] == k
    assert [s["step"] for s in trace.spans("update")] == [0, 1, 2]
    assert adam.state["count"] == 3


def test_collect_gathers_spans_device_ms_and_counters(scene, traced):
    _fit_steps(scene, 1)
    out = trace.collect()
    assert set(out) == {"spans", "device_ms", "counters"}
    assert len(out["spans"]) == len(FORWARD + BACKWARD) + 1 and out["device_ms"] == {}
    counters = out["counters"]
    assert set(counters) >= {"launches", "graphs", "slot_table_builds", "bins"}
    assert counters["launches"] == rc.LAUNCHES and counters["graphs"] == rc.GRAPHS
    assert set(counters["bins"]) == set(rc.BIN_COUNT_FIELDS)


@pytest.mark.parametrize("cut", [1, "all"])
def test_k7_counts_capped_binnings(scene, monkeypatch, cut):
    """A binned render as a caller's capture holds it (``capturing``
    patched true after an eager warm-up) under ``forced_capacity``: the
    images are the eager bits, and K7's counts (``graphs.bin_counters``)
    add one binning, the pair total, the capacity and the overflow bins
    of each capped binning; eager binnings add nothing;
    ``reset_launches`` zeroes them."""
    r, v, f = scene
    faces = f.clone()

    def render():
        with rc.forced_route("binned"):
            return r.render_silhouettes(v, faces)

    rc.reset_launches()
    want = render()
    (total,) = graphs.faces_record(faces).bin_totals.values()
    assert graphs.bin_counters() == dict.fromkeys(rc.BIN_COUNT_FIELDS, 0)
    capacity = total - 1 if cut == 1 else 0
    words = []
    bin_faces = rc.bin_faces

    def keep_words(*args, capacity=None, **kwargs):
        out = bin_faces(*args, capacity=capacity, **kwargs)
        words.append(int(out[3]))
        return out

    monkeypatch.setattr(rc, "bin_faces", keep_words)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    with graphs.forced_capacity(capacity):
        for _ in range(2):
            assert torch.equal(render(), want)
    counts = graphs.bin_counters()
    assert words[0] > 0 and words == words[:1] * 2
    assert counts == dict(binnings=2, pairs=2 * total, slots=2 * capacity,
                          overflow_bins=2 * words[0])
    rc.reset_launches()
    assert graphs.bin_counters() == dict.fromkeys(rc.BIN_COUNT_FIELDS, 0)


@pytest.mark.parametrize("name", ["bin_overflow_per_step", "bin_slot_use_pct"])
def test_bin_readers_read_the_ports_counts(monkeypatch, name):
    """The benchmark's readers of K7's counts: None where the port keeps no
    counts (a port without ``bin_counters``) or made no capped binning
    (the tiled route), whatever the context; else overflow bins a binning
    and the pairs' share of the slots."""
    from portbench.harness import spec

    read = spec.reader(name)
    want = {"bin_overflow_per_step": 3 / 4, "bin_slot_use_pct": 100.0 * 600 / 2048}[name]
    monkeypatch.delattr(graphs, "bin_counters")
    assert read({}) is None
    monkeypatch.setattr(graphs, "bin_counters",
                        lambda: dict.fromkeys(rc.BIN_COUNT_FIELDS, 0), raising=False)
    assert read({"stages": None}) is None
    monkeypatch.setattr(graphs, "bin_counters", lambda: dict(
        binnings=4, pairs=600, slots=2048, overflow_bins=3))
    assert read({}) == pytest.approx(want)
