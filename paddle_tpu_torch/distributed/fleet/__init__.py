"""paddle_tpu_torch.distributed.fleet — only ``runtime.fault_injection``
and ``runtime.rpc`` so far."""
