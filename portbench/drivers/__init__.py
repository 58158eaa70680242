"""One traffic kind a module: ``setup(ctx)`` returns a session whose
``unit()`` is one unit of the timed work (``run.py``)."""
