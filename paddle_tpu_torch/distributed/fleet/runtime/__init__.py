"""paddle_tpu_torch.distributed.fleet.runtime — the fault injector
(``fault_injection``) and the multiplexed RPC wire (``rpc``) the serving
frontend speaks (the PS runtime and its tiered store wait for ROADMAP
item 16)."""
