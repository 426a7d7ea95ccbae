"""The pieces ``tools/serving_precision.py --pieces`` compiles alone are the
test-mode forward's own: the encoders piece is ``PriOrRAFT.encode``, the
encoders' parts are what it computes inside, and one step piece, upsampled,
is the 1-iteration forward, bitwise (bf16 mixed precision on the CPU, 32x64,
no compile)."""

import torch

from prior_flow_tpu_torch.models.prior_raft import _nhwc, upsample_flow_convex
from prior_flow_tpu_torch.tools import serving_precision as sp

H, W = 32, 64


def test_pieces_are_the_forwards_own():
    dev = torch.device("cpu")
    model = sp.eager_model("bf16", 0, dev)
    images = sp.piece_inputs("encode", model, H, W, dev)
    enc = sp.run_piece("encode", model, images, H, W)
    with torch.no_grad():
        want = model.encode(*images, model.rotation_grids(H, W, dev))
    for got, ref in zip(enc, (*want[:4], *want[4])):
        assert torch.equal(got, ref)

    views = sp.piece_inputs("cnet", model, H, W, dev)
    cnet_A, cnet_B = sp.run_piece("cnet", model, views, H, W)
    hd = model.hidden_dim
    assert torch.equal(torch.tanh(cnet_A[:, :hd]), enc[0])
    assert torch.equal(torch.relu(cnet_B[:, hd:]), enc[3])
    fmaps = sp.run_piece("fnet", model, views, H, W)
    for got, ref in zip(fmaps, enc[4:]):
        assert torch.equal(_nhwc(got.float()), ref)
    for stem in ("cnet_stem", "fnet_stem"):
        (out,) = sp.run_piece(stem, model, views, H, W)
        assert out.shape[2:] == (H // 2, W // 2) and torch.isfinite(out).all()

    inputs = sp.piece_inputs("step", model, H, W, dev)
    step = sp.run_piece("step", model, inputs, H, W)
    assert len(step) == len(sp.OUTPUTS["step"])
    flow = upsample_flow_convex(step[2] - inputs[6], _nhwc(step[4]))
    assert torch.equal(flow, model(*images, iters=1))
