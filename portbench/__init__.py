"""The benchmark of the PyTorch and CUDA port (``tpu_renderer_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Everything a cell is made of is found by its
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` and the scene's ``generators/<kind>.py``.
"""
