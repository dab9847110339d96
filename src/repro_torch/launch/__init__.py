"""Entry points: LM serving (``serve.py``)."""
