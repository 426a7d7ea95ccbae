"""The legacy RAFT basic as the program builds it, and what the benchmark
counts."""

from __future__ import annotations

from benchmark.reference import raft as reference

VIEWS = {"fnet": 2, "cnet": 1}
VOLUMES = 1
TEST_MASKS = ("update_block",)


def param_spec(cfg):
    return reference.param_spec(cfg)


def build(cfg, state_dict, traffic, device):
    from prior_flow_tpu_torch.models import build_raft
    model = build_raft(device, state_dict=state_dict, hidden_dim=cfg["hidden_dim"],
                       context_dim=cfg["context_dim"], corr_levels=cfg["corr_levels"],
                       corr_radius=cfg["corr_radius"],
                       mixed_precision=traffic["precision"] == "bf16")
    return model
