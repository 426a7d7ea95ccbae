"""PriOr-RAFT as the program builds it, and what the benchmark counts."""

from __future__ import annotations

from benchmark.reference import priorraft as reference

# views each encoder runs per pair, and the correlation volumes per pair
VIEWS = {"fnet": 4, "cnet": 2}
VOLUMES = 2
# the update blocks whose mask head runs in a test-mode forward (its last iteration)
TEST_MASKS = ("ODDC",)


def param_spec(cfg):
    return reference.param_spec(cfg)


def build(cfg, state_dict, traffic, device):
    from prior_flow_tpu_torch.models import build_model
    model = build_model(device, state_dict=state_dict, hidden_dim=cfg["hidden_dim"],
                        context_dim=cfg["context_dim"], corr_levels=cfg["corr_levels"],
                        corr_radius=cfg["corr_radius"],
                        mixed_precision=traffic["precision"] == "bf16")
    return model
