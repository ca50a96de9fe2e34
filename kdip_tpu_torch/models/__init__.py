"""ADM UNet models (PyTorch port of `kdip_tpu/models`)."""
