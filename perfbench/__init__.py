"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON result as its last line.  What a cell
is made of sits in files of their own, found by name:

* ``configs/<config>.json``: a deployment (collection, kernel settings,
  guarantee, cuts);
* ``traffic/<mix>.json``: the parameters of a traffic mix, and the loop
  that drives it;
* ``loops/<loop>.py``: a loop's set-up, window and end-to-end numbers;
* ``workloads/<cell>.json``: a cell's configuration, mix and parameters;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick (``gen.py``, ``roofline.py``, ``tracing.py``, ``check.py`` and
``reference/``) imports nothing of the program; ``system.py`` is the one
module that reaches into ``repro_torch``.
"""
