"""The program's side of each configuration's fit, one module a fit,
named as the configuration's ``reference`` names its plain reference
(``spec.task``).  A task module gives:

- ``FORMS``: the traffic forms it runs (``"whole"``; ``"sharded"`` where
  its images go through the port's sharded entry on ``fit.mesh``);
- ``make_inputs(cfg, seed, device)``: dict with ``leaves`` (name ->
  float32 tensor [O, ...], each object its rows, in the order the
  optimiser takes them), ``faces`` [nf, 3] int32, ``eyes`` [B, 3] (the
  renderer's viewpoints), ``viewing_angle``, ``image_size``,
  ``anti_aliasing``, ``targets`` [B, ...], ``batch`` (B: a step's output
  pixels are B x image_size^2), and whatever else its images and its
  reference read.  Every tensor in it may be held by a captured step:
  ``Fit.reset`` copies another seed's into it;
- ``images(fit, leaves)``: the images [B, ...] of the leaves through the
  port's facade (``fit.renderer``, its camera set from the inputs;
  ``fit.nr``, ``fit.faces``, ``fit.inputs``);
- ``loss(images, targets)``: the fit's scalar loss, a ``def loss``;
- ``step_work(cfg, inputs, leaves0)``: the yardstick's counts of a step at
  the seed's leaves ({function: (bytes, operations)}), or None.

A traced run names the stage of each operation of the captured step by
the innermost function on the stack that ``harness/stages.py`` knows: the
port's by their names, the task's by these two.  What ``images`` does
before the facade call (each image's copy of its object's leaves) goes in
a function named ``views``, the camera's stage; what ``loss`` does is the
loss stage's.  An operation of the task's own in any other function falls,
with no error, into the stage that is open.
"""
