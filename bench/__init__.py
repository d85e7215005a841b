"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON line.
Everything a cell names lives in a file of its own, found by that name:
``configs/<config>.json`` (the model as run, with its plain reference named
by ``reference``), ``traffic/<mix>.json`` (read by the driver it names in
``drivers/``), ``limits/<cell>.json`` (the limits that decide ``correct``)
and ``metrics/<metric>.py`` (one reader a metric).  Nothing here imports
JAX or the JAX package; ``reference/`` imports nothing of the port either.
"""
