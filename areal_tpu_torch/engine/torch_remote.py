"""Backend of the port's generation server, and the remote client over it
(the port of `areal_tpu/engine/jax_remote.py`).

The wire format is the JAX server's, which the port's server speaks too
(`gen/server.py`):

    POST /generate                     {rid, group_id, group_n, trace_id,
                                        input_ids, sampling_params}
    POST /pause_generation             {}
    POST /continue_generation          {}
    POST /update_weights_from_disk     {path, version?}
    POST /update_weights_chunk         octet-stream pieces, then
                                       {prepare, version}, {commit, version, live}

Responses carry `output_tokens`, `output_logprobs`, `stop_reason` and the
server's weight `version`.  A transfer publish is the trainer's
(`TorchTrainEngine.stage_weights` / `update_weights`): the client sends
nothing for it.  A request with `pixel_values` raises: the port serves no
VLM yet.
"""

from typing import Any, Dict

from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.io_struct import (
    HttpGenerationResult,
    HttpRequest,
    ModelRequest,
    WeightUpdateMeta,
    WeightUpdateRequests,
)
from areal_tpu_torch.core.remote import RemoteInfEngine


class TorchBackend:
    def build_generation_request(self, req: ModelRequest) -> HttpRequest:
        if req.pixel_values is not None:
            raise NotImplementedError("VLM requests are not ported (pixel_values)")
        g = req.gconfig
        payload = {
            "rid": req.rid,
            "group_id": req.group_id,
            "group_n": req.group_n,
            "trace_id": req.trace_id or req.rid,
            "input_ids": list(req.input_ids),
            "sampling_params": {
                "max_new_tokens": g.max_new_tokens,
                "min_new_tokens": g.min_new_tokens,
                "temperature": 0.0 if g.greedy else g.temperature,
                "top_p": g.top_p,
                "top_k": g.top_k,
                "stop_token_ids": list(g.stop_token_ids),
            },
        }
        return HttpRequest(endpoint="/generate", payload=payload)

    def parse_generation_response(self, resp: Dict[str, Any]) -> HttpGenerationResult:
        return HttpGenerationResult(
            output_tokens=list(resp["output_tokens"]),
            output_logprobs=list(resp["output_logprobs"]),
            stop_reason=resp["stop_reason"],
            version=int(resp.get("version", -1)),
            cache_hit_tokens=int(resp.get("cache_hit_tokens", 0)),
        )

    def build_pause_request(self) -> HttpRequest:
        return HttpRequest(endpoint="/pause_generation", payload={})

    def build_resume_request(self) -> HttpRequest:
        return HttpRequest(endpoint="/continue_generation", payload={})

    def build_weight_update_requests(self, meta: WeightUpdateMeta) -> WeightUpdateRequests:
        if meta.type == "disk":
            payload: Dict[str, Any] = {"path": meta.path}
            if meta.version is not None:
                payload["version"] = int(meta.version)
            return WeightUpdateRequests(requests=[
                HttpRequest(endpoint="/update_weights_from_disk", payload=payload)])
        if meta.type == "transfer":
            # the trainer already streamed and committed the weights
            return WeightUpdateRequests(requests=[])
        raise NotImplementedError(f"weight update type {meta.type!r}")


class RemoteTorchEngine(RemoteInfEngine):
    """Inference-engine client of the port's generation servers."""

    def __init__(self, config: InferenceEngineConfig):
        super().__init__(config, backend=TorchBackend())
