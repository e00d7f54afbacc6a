"""paddle_tpu_torch.distributed.fleet.runtime — the fault injector
(``fault_injection``), the multiplexed RPC wire (``rpc``) the serving
frontend and the PS tier speak, and the parameter-server runtime
(``parameter_server_runtime``: shards, clients, snapshots). The HA
replication plane and the tiered store wait for ROADMAP item 16(b)."""
