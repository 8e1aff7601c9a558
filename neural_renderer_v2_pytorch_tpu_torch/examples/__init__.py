"""The reference's example workloads on the port (counterparts of the JAX
package's ``examples/``), each runnable as

    python -m neural_renderer_v2_pytorch_tpu_torch.examples.example1 [flags]

with the JAX examples' flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions).  Their default inputs are the files
``utils.scenes.write_example_data("data", 256)`` writes (a torus OBJ and
target images, in place of the reference's teapot data, which the
repository does not ship)."""
