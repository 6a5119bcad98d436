"""The examples of the PyTorch port: ``examples/`` on ``repro_torch``.

  PYTHONPATH=src python -m examples_torch.run NAME [--device cuda|cpu]
      [script args...]

``serve_fleet`` and ``serve_under_volatility`` are copies of the
reference's scripts (import lines retargeted); ``quickstart``,
``train_lm`` and ``elastic_rescale`` are ports with a ``--device`` flag of
their own. Every one runs on the card unless the CPU is named.
"""
