"""The yardstick's arithmetic, frozen with the benchmark: the card's
published peaks (``peaks``), the model FLOPs a configuration's shapes
need (``model``) and each kernel's needed operations and bytes
(``kernels``). Nothing here reads the program."""
