"""The name_resolve key layout (the port's copy of `areal_tpu/utils/names.py`,
the same keys, so a port process and a JAX process rendezvous in one store)."""

ROOT = "areal_tpu"


def _join(*parts: str) -> str:
    return "/".join([ROOT, *[p for p in parts if p]])


def trial_root(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name)


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name, "gen_servers")


def gen_server(experiment_name: str, trial_name: str, server_idx: str) -> str:
    return _join(experiment_name, trial_name, "gen_servers", str(server_idx))


def update_weights_from_disk(experiment_name: str, trial_name: str, model_version) -> str:
    return _join(experiment_name, trial_name, "update_weights_from_disk", str(model_version))


def weight_version(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name, "weight_version")


def trainer_master(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name, "trainer_master")


def distributed_lock(experiment_name: str, trial_name: str, lock_name: str) -> str:
    return _join(experiment_name, trial_name, "locks", lock_name)


def worker(experiment_name: str, trial_name: str, worker_type: str, idx) -> str:
    return _join(experiment_name, trial_name, "workers", worker_type, str(idx))


def worker_root(experiment_name: str, trial_name: str, worker_type: str) -> str:
    return _join(experiment_name, trial_name, "workers", worker_type)


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name, "status")


def gen_router(experiment_name: str, trial_name: str) -> str:
    return _join(experiment_name, trial_name, "gen_router")
