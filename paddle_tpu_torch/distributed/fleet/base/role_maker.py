"""Role makers (counterpart of
``paddle_tpu/distributed/fleet/base/role_maker.py``; reference
distributed/fleet/base/role_maker.py).

Read the PADDLE_* env set by the launcher or ``spawn``; rendezvous is the
process group's (``env.init_parallel_env``)."""
from __future__ import annotations

import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = ["127.0.0.1:6170"]
        self._server_endpoints = []

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return len(self._worker_endpoints)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def _barrier(self, comm_world=None):
        from ...collective import barrier
        barrier()

    def _generate_role(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else ["127.0.0.1:6170"]
        seps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = seps.split(",") if seps else []
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER
        if self._role == Role.SERVER:
            self._current_id = int(os.environ.get("PADDLE_PORT_INDEX", "0"))


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None, **kwargs):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = server_endpoints or []
        self._worker_endpoints = worker_endpoints or \
            [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]
