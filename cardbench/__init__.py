"""The benchmark of the PyTorch/CUDA port: ``python3 cardbench/run.py``.

See ``run.py`` for a run, ``harness.py`` for how a cell is found and
served, ``check.py`` for the correctness check and ``reference/`` for the
plain references it judges by."""
