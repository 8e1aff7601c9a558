"""Sizes the CPU tests run the cells at: the cells' configurations cut so
that the port's plain kernels and the reference finish in seconds."""

SMALL = {
    "recon642-b128-whole": dict(mesh={"kind": "icosphere", "level": 2, "radius": 0.5},
                                vertices=162, faces=320, objects=3, views_per_object=2, azimuths=6,
                                image_size=24),
    "mesh164k-v32-512-whole": dict(mesh={"kind": "torus", "n_major": 20, "n_minor": 12,
                                         "major_radius": 0.6, "minor_radius": 0.25},
                                   vertices=240, faces=480, objects=1, views_per_object=4,
                                   azimuths=4, image_size=32),
}
SMALL["mesh164k-v32-512-tile4"] = SMALL["mesh164k-v32-512-whole"]
# the four-card cell of the sharded form (traffic/tile4.json), which
# BENCHMARK.json does not list: the tests run it on four gloo ranks
TILE4 = {"name": "mesh164k-v32-512-tile4", "config": "mesh164k-v32", "traffic": "tile4",
         "chips": 4}
# the entries of the cells in SMALL that BENCHMARK.json does not list
UNLISTED = {TILE4["name"]: TILE4}
SEED = 2 ** 33 + 12345
