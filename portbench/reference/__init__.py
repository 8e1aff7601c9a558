"""Plain references, one module a fit, named by the configuration's
``reference`` (``spec.reference``).  A reference imports nothing of the
program and gives ``run(inputs, steps, dtype=torch.float32, fault=None)``:
``steps`` steps of the fit from the task's inputs (``tasks/``), their
``leaves`` replaced by the seed's and ``optimizer`` added (lr,
beta1, beta2, eps), every step computed in ``dtype``; it returns
dict(losses [steps], grad1 and params, each a dict of one float32 tensor
a leaf).  ``fault``: "half_batch", "altered" or "frozen", planted as the
harness plants them in the program (``harness/fit.py``)."""
