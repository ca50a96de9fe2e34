"""Command-line entry points of the PyTorch port (`python -m
kdip_tpu_torch.cli.<name>`)."""
