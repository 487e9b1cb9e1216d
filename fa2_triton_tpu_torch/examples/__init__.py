"""Runnable examples of the PyTorch port (`python -m fa2_triton_tpu_torch.examples.train`)."""
