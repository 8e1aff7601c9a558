"""The port's OBJ/MTL I/O and image helpers against the JAX package's, on
files this test writes: loaded arrays equal (``np.array_equal``), with and
without normalization, through the C++ and the Python parser, and saved
files that each package loads back as the other wrote them."""

import inspect

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu_torch.utils import native_loader
from neural_renderer_v2_pytorch_tpu_torch.utils import obj_io as tobj

# quads, a pentagon, v/vt and v/vt/vn tokens, three materials (two images
# of different widths, one flat Kd), comments and blank lines
TEXTURED_OBJ = """# a test scene
mtllib scene.mtl

v 0.0 0.0 0.0
v 1.5 0.0 0.25
v 1.5 1.0 0.0
v 0.0 1.0 -0.5
v 2.0 2.0 1.0
v -1.0 0.5 0.125
v 0.5 -1.0 0.75
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
vt 0.25 0.75
vn 0 0 1

usemtl image_a
f 1/1 2/2 3/3 4/4
f 2/2 5/5 3/3
# the pentagon, with normals
usemtl image_b
f 1/1/1 2/2/1 5/5/1 6/4/1 7/3/1
usemtl flat
f 4/1 6/2 7/3
f 1/4 3/5 6/1 7/2
"""

TEXTURED_MTL = """# materials
newmtl image_a
Kd 1 1 1
map_Kd a.png

newmtl image_b
map_Kd b.png
newmtl flat
Kd 0.25 0.5 0.75
"""

# geometry only: v//vn tokens, a bare-index quad and pentagon
GEOMETRY_OBJ = """# geometry
v 0.5 0.25 -1.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0

v 0.0 1.0 0.5
v -0.5 2.0 0.25
vn 0 0 1
f 1//1 2//1 3//1
f 1 2 3 4
f 1/2/1 3/2/1 4/2/1 5/2/1 2/2/1
"""


@pytest.fixture
def scene(tmp_path):
    rng = np.random.RandomState(0)
    (tmp_path / "scene.obj").write_text(TEXTURED_OBJ)
    (tmp_path / "scene.mtl").write_text(TEXTURED_MTL)
    imageio.imwrite(tmp_path / "a.png", (rng.rand(4, 6, 3) * 255).astype(np.uint8))
    imageio.imwrite(tmp_path / "b.png", (rng.rand(5, 10, 4) * 255).astype(np.uint8))
    (tmp_path / "geometry.obj").write_text(GEOMETRY_OBJ)
    return tmp_path


def _np(ts):
    return [t.numpy() for t in ts]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalization", [True, False])
def test_load_obj_textured_matches_jax(scene, normalization):
    path = str(scene / "scene.obj")
    want = jnr.load_obj(path, normalization, load_textures=True)
    got = tnr.load_obj(path, normalization, load_textures=True, device="cpu")
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32
    _assert_equal(_np(got), want)
    # three materials: an atlas of 4 + 5 + 2 rows, 10 wide
    assert got[4].shape == (3, 11, 10)
    # the positional flag of the reference's signature
    _assert_equal(_np(tnr.load_obj(path, normalization, True, device="cpu")), want)


@pytest.mark.parametrize("normalization", [True, False])
def test_load_obj_geometry_matches_jax(scene, normalization):
    path = str(scene / "geometry.obj")
    want = jnr.load_obj(path, normalization)
    got = tnr.load_obj(path, normalization, device="cpu")
    _assert_equal(_np(got), want)
    assert got[1].shape == (1 + 2 + 3, 3)


@pytest.mark.parametrize("name", ["scene.obj", "geometry.obj"])
def test_native_and_python_parsers_agree(scene, name, monkeypatch):
    path = str(scene / name)
    assert native_loader.get_lib() is not None       # g++ builds it here
    native = tnr.load_obj(path, False, device="cpu")
    monkeypatch.setattr(tobj, "parse_obj_native", lambda filename: None)
    python = tnr.load_obj(path, False, device="cpu")
    _assert_equal(_np(python), _np(native))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnr.load_obj(str(tmp_path / "absent.obj"), device="cpu")


def test_load_obj_defaults_to_the_card():
    assert inspect.signature(tnr.load_obj).parameters["device"].default == "cuda"


def test_load_mtl_matches_jax(scene):
    want = jnr.load_mtl(str(scene / "scene.mtl"))
    got = tnr.load_mtl(str(scene / "scene.mtl"))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for key in want[name]:
            np.testing.assert_array_equal(got[name][key], want[name][key])


def test_save_obj_round_trips_between_packages(scene, tmp_path):
    """The same arrays saved by each package: the same files, and each
    package loads the other's as its own."""
    v, f, vt, ft, tex = jnr.load_obj(str(scene / "scene.obj"), load_textures=True)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_obj, jax_obj = str(tmp_path / "port" / "m.obj"), str(tmp_path / "jax" / "m.obj")
    tnr.save_obj(port_obj, torch.tensor(v), torch.tensor(f), torch.tensor(vt),
                 torch.tensor(ft), torch.tensor(tex))
    jnr.save_obj(jax_obj, v, f, vt.copy(), ft, tex)
    for ext in (".obj", ".mtl"):
        assert open(port_obj[:-4] + ext).read() == open(jax_obj[:-4] + ext).read()
    np.testing.assert_array_equal(imageio.imread(port_obj[:-4] + ".png"),
                                  imageio.imread(jax_obj[:-4] + ".png"))
    _assert_equal(_np(tnr.load_obj(jax_obj, load_textures=True, device="cpu")),
                  jnr.load_obj(port_obj, load_textures=True))
    # and without textures
    tnr.save_obj(port_obj, v, f)
    jnr.save_obj(jax_obj, v, f)
    assert open(port_obj).read() == open(jax_obj).read()


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    for shape in [(6, 5), (6, 5, 3), (6, 5, 4)]:
        image = rng.rand(*shape).astype(np.float32)
        tnr.imsave(str(tmp_path / "port.png"), torch.tensor(image))
        jnr.imsave(str(tmp_path / "jax.png"), image)
        np.testing.assert_array_equal(tnr.imread(str(tmp_path / "jax.png")),
                                      jnr.imread(str(tmp_path / "port.png")))
    # a palette image reads as imageio reads it
    from PIL import Image

    Image.fromarray((rng.rand(6, 5, 3) * 255).astype(np.uint8)).convert("P").save(
        tmp_path / "palette.png")
    np.testing.assert_array_equal(tnr.imread(str(tmp_path / "palette.png")),
                                  jnr.imread(str(tmp_path / "palette.png")))

    frames = [rng.rand(8, 8) for _ in range(3)]
    for i, frame in enumerate(frames):
        tnr.imsave(str(tmp_path / ("_tmp_%04d.png" % i)), frame)
    tnr.make_gif(str(tmp_path), str(tmp_path / "out.gif"))
    assert len(imageio.mimread(tmp_path / "out.gif")) == 3
    assert not list(tmp_path.glob("_tmp_*.png"))


def test_to_device():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tnr.to_device(a, "cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jnr.to_device(a)))
    out = tnr.to_gpu([a, torch.ones(2), jnp.zeros(3)], device="cpu")
    assert [x.shape for x in out] == [(2, 3), (2,), (3,)]
    assert inspect.signature(tnr.to_device).parameters["device"].default == "cuda"
