"""The reference's four examples on the port, one module each:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_adaptive_lm [--kv-bits 8]
  PYTHONPATH=src python -m repro_torch.examples.train_restartable_lm --steps 60
  PYTHONPATH=src python -m repro_torch.examples.adaptive_cnn [--steps 120]

Each takes the reference example's flags plus ``--device`` (default: cuda)
and is a function with optional parameters, so a caller can hand it
weights of its own (``models/convert.py::params_from_jax``).
"""
