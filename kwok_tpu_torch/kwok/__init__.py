"""The kwok entry point on the port's engine (``python -m kwok_tpu_torch.kwok``)."""
