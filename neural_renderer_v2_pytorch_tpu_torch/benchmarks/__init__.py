"""The port's measurement modules (counterparts of the JAX package's
``bench.py`` and ``benchmarks/``), each runnable on one CUDA card as

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.<name> [flags]

- ``bench``: ``bench.py``'s step (256^2 silhouettes with anti-aliasing,
  its loss and update), chained as CUDA-graph replays; one JSON line in
  pixels/s, beside the eager and graphed-core forms.
- ``measure_time``: silhouette and textured forward and forward+backward
  over azimuths, in the graphed-core form.
- ``scaling``: the thirteen rows of the JAX package's perf matrix on
  in-repo meshes, each in the eager, graphed-core and whole-step forms.
- ``prof``: the device time of each stage of a replayed whole step, a
  stage being one of the port's spans (``utils/trace.py``).
- ``kernel_census``: one step's device operations and kernel launches in
  each form.
- ``roofline``: each kernel's bytes and operations, its bound and its
  device time in a replayed step, beside the one PyTorch call that
  computes the same function.

``steps`` holds what they share: the step and its forms, the CUDA-event
median, the chain and the profiler's reading.  Each module's functions take
an explicit ``device``, so the tests run them on the CPU (the kernels'
plain versions; no timing); each ``main()`` needs a card and exits with
status 2 without one.  Imports no JAX."""
