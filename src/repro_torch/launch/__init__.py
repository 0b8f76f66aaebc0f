"""Entry points of the port: ``serve`` (``python -m
repro_torch.launch.serve``).  Importing the package loads none of them."""
