"""X-Pack features of the port: machine learning (``ml.py``)."""
