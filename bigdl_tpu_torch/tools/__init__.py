"""Command-line tools of the port: the launcher (``launch.py``)."""
