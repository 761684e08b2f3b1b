"""Entry points of the model families: ``steps`` (init and serving
functions per arch) and ``serve`` (the serving driver)."""
