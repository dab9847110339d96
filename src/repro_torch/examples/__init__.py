"""The README's examples on the port, one module each (the counterparts of
``examples/*.py``), run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [flags] [--torch-device cpu]

``train_lm``, ``serve_lm``, ``moe_pipeline``, ``ida_pipeline``,
``preemptive_serving``, ``hetero_pipeline``, ``serve_pipelines`` and
``quickstart``. Each keeps its reference's flags and adds
``--torch-device`` (the card by default; ``cuda`` without a card raises).
Nothing runs at import: ``run(...)`` prints the example's lines and returns
its numbers as a dict (its keyword arguments are the example's sizes),
``main(argv)`` parses the flags and calls it.
"""
