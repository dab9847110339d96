"""Entry points: LM serving (``serve.py``) and training (``train.py``)."""
