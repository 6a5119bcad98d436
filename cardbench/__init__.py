"""The benchmark of the PyTorch/CUDA port: ``python3 cardbench/run.py``.

See ``run.py`` for a run, ``harness.py`` for how a cell is found and
served, ``check.py`` for the correctness check, ``programs/`` for how a
configuration becomes the program's and ``reference/`` for the plain
references it is judged by."""
