"""Plain PyTorch references of the benchmark's configurations: the
transformer (``transformer.py``) and one module a feed-forward kind
(``dense.py``, ``moe.py``), found by the ``ffn`` key of a configuration
file. They import nothing of the program."""
