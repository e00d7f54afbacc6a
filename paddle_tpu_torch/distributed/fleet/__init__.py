"""paddle_tpu_torch.distributed.fleet — only ``runtime.fault_injection``
so far."""
