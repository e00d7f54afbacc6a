"""paddle_tpu_torch.distributed — only ``fleet.runtime.fault_injection``
(the fault injector the checkpoint writer, the serving engine and the
wire call) and ``fleet.runtime.rpc`` (the multiplexed wire the serving
frontend speaks) so far; the collectives, the mesh and the fleet facade
of ``paddle_tpu.distributed`` are not ported yet (ROADMAP.md A)."""
