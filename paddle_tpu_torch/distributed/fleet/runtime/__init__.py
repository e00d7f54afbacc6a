"""paddle_tpu_torch.distributed.fleet.runtime — only ``fault_injection``
so far (the PS runtime, its RPC wire and tiered store are not
ported)."""
