"""The port's twins of the JAX package's ``examples/*.py``: one module per
example, of the same file name, each runnable as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Each defines ``run(..., device="cuda") -> dict``, which returns every
number its script prints (and the arrays behind them), and ``main(argv)``
with the reference's own flags and ``--device`` (the card by default; it
raises without one, as ``EngineConfig.device`` does). Problems are drawn
with the port's ``sample_problem`` (``torch.Generator``, not JAX's numbers);
``run`` also takes the ``(s0, a, y)`` arrays, so one problem can go
through both packages. Importing a twin does no work.
"""
