"""Service invocation: the header policy and the app-id resolver (the
port of ``tasksrunner/invoke/headers.py`` and ``resolver.py``)."""
