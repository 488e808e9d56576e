"""One module a kind of cell (a traffic file's ``driver``): ``train``
so far. Each has ``setup``, ``window``, ``close`` and ``check``
(``portbench/harness.py``)."""
