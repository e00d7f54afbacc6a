"""fleetrun — ``python -m paddle_tpu_torch.distributed.fleet.launch``
(counterpart of ``paddle_tpu/distributed/fleet/launch.py``).

Reference python/paddle/distributed/fleet/launch.py (console entry
`fleetrun`): the same engine as paddle_tpu_torch.distributed.launch,
with --servers/--workers parameter-server mode as the first-class
interface.
"""
from ..launch import launch, main

__all__ = ["launch", "main"]

if __name__ == "__main__":
    main()
