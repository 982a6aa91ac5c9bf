"""The dense BCPNN forward kernel of several checkouts side by side on one
card: its rates against an fp64 forward on log-odds and random operands,
and its device time at Model 1's and the head's shapes.

    python3 tools/compare_fwd.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo (its ``src/`` holds ``repro_torch``);
each runs in a process of its own, in the order given, so ``parent change
change parent`` compares two commits within one call.  The kernel is built
from each root's sources into that root's ``build/``.  Operand families:

* ``head``: the BCPNN head on qwen1.5-0.5b's mean-pooled final hidden
  states (128 ``TokenStream`` rows, seeds as ``chip_smoke.py`` phase 11),
  after one plain-path unsupervised step; ``head-centred`` the same with
  each weight row's mean taken out (the same rates in exact arithmetic);
* ``head-chained``: the kernel's rates on the state the kernel path's own
  unsupervised step gives, against the fp64 rates of the plain path's
  state (two states, not one: what a chained comparison measures);
* ``logodds-*``: complementary input rates, weights uniform in [-5.7,
  1.2], biases in [-9, -7] (supports of thousands), at the head's, Model
  1's and a readout's shapes; ``rand-*``: phase 1's draws.

For each: the kernel's and the plain (cuBLAS) path's largest distance from
the fp64 rates, and whether the kernel keeps phase 3's rule (no further
than max(1e-5, twice the plain path)); the median of (kernel log-rate
difference / fp64 support difference - 1) within an HC (a gain-like bias
shows as a nonzero median).  Times: CUDA events, the median of 5 windows
of 200 calls.  Needs one CUDA card.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path


def _families(torch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import head
    from repro_torch.core.network import unsupervised_step
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import lm
    cfg = get_config("qwen1.5-0.5b")
    params = lm.init_params(cfg, 0, "cuda")
    with torch.no_grad():
        toks = torch.from_numpy(TokenStream(cfg.vocab, seed=2).batch(
            0, 128, 32)).cuda()
        feats = lm.forward(params, cfg, toks).mean(dim=1)
    del params
    hcfg = head.BCPNNHeadConfig(feature_dim=cfg.d_model)
    plain = dataclasses.replace(hcfg.network_config(), backend="torch")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    noise = torch.randn((128, hcfg.hidden_hc * hcfg.hidden_mc),
                        generator=gen, device="cuda")
    st0 = head.init_head(hcfg, 5, "cuda")
    x = head.encode_features(feats, hcfg.encode_gain).float().contiguous()
    st_p = unsupervised_step(st0, plain, x, noise=noise)
    st_k = head.head_unsupervised(st0, hcfg, feats, noise=noise)
    w, b = st_p.projs[0].w.contiguous(), st_p.projs[0].b.contiguous()
    yield "head", x, w, b, None, 16, 64
    yield ("head-centred", x, (w - w.mean(1, keepdim=True)).contiguous(), b,
           None, 16, 64)
    yield ("head-chained", x, w, b, (st_k.projs[0].w.contiguous(),
                                     st_k.projs[0].b.contiguous()), 16, 64)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for name, hi, hj, mj in (("logodds-head", 1024, 16, 64),
                             ("logodds-model1", 784, 32, 128),
                             ("logodds-readout", 512, 1, 10)):
        p = torch.sigmoid(4 * torch.randn((128, hi), generator=g,
                                          device="cuda"))
        xx = torch.stack([p, 1 - p], -1).reshape(128, 2 * hi).contiguous()
        ww = torch.rand((2 * hi, hj * mj), generator=g,
                        device="cuda") * 6.9 - 5.7
        bb = torch.rand((hj * mj,), generator=g, device="cuda") * 2 - 9
        yield name, xx, ww, bb, None, hj, mj
    for name, ni, hj, mj in (("rand-model1", 1568, 32, 128),
                             ("rand-head", 2048, 16, 64)):
        xx = torch.rand((128, ni), generator=g, device="cuda")
        ww = torch.randn((ni, hj * mj), generator=g, device="cuda") * 0.1
        bb = torch.randn((hj * mj,), generator=g, device="cuda") * 0.1
        yield name, xx, ww, bb, None, hj, mj


def _median_us(torch, fn):
    for _ in range(20):
        fn()
    wins = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(200):
            fn()
        e.record()
        e.synchronize()
        wins.append(s.elapsed_time(e) / 200 * 1e3)
    return sorted(wins)[2]


def worker(tag: str) -> None:
    import torch

    from repro_torch.kernels.bcpnn_fwd import bcpnn_fwd_cuda
    from repro_torch.kernels.ref import ref_bcpnn_fwd
    for name, x, w, b, kernel_wb, hj, mj in _families(torch):
        s64 = b.double() + x.double() @ w.double()
        r64 = torch.softmax(s64.view(-1, hj, mj), -1).view(len(x), -1)
        rk = bcpnn_fwd_cuda(x, *(kernel_wb or (w, b)), hj, mj)
        rp = ref_bcpnn_fwd(x, w, b, hj, mj)
        ek = (rk.double() - r64).abs().max().item()
        ep = (rp.double() - r64).abs().max().item()
        lr = torch.log(rk.double().clamp_min(1e-300)).view(-1, hj, mj)
        s = s64.view(-1, hj, mj)
        top = s.argmax(-1, keepdim=True)
        d_r, d_s = lr - lr.gather(-1, top), s - s.gather(-1, top)
        keep = (rk.view(-1, hj, mj) > 1e-5) & (d_s < -1)
        bias = ((d_r[keep] / d_s[keep]) - 1).median().item() \
            if bool(keep.any()) else float("nan")
        rule = "keeps" if ek <= max(1e-5, 2 * ep) else "BREAKS"
        print(f"[{tag}] {name:16s} |s| max {s64.abs().max().item():8.1f}: "
              f"rates from fp64 kernel {ek:.3e}, plain {ep:.3e}; {rule} "
              f"max(1e-5, 2 x plain); log-rate bias {bias:+.3e}",
              flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for name, ni, hj, mj, bf16 in (("model1", 1568, 32, 128, False),
                                   ("model1-bf16", 1568, 32, 128, True),
                                   ("head", 2048, 16, 64, False),
                                   ("head-readout", 1024, 1, 10, False)):
        x = torch.rand((128, ni), generator=g, device="cuda")
        w = torch.randn((ni, hj * mj), generator=g, device="cuda") * 0.1
        b = torch.randn((hj * mj,), generator=g, device="cuda") * 0.1
        if bf16:
            w, b = w.bfloat16(), b.bfloat16()
        us = _median_us(torch, lambda: bcpnn_fwd_cuda(x, w, b, hj, mj))
        print(f"[{tag}] time {name}: {us:.2f} us", flush=True)


def main(roots) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for i, root in enumerate(roots):
        root = Path(root).resolve()
        tag = f"{i}:{root.name}"
        env = {**os.environ, "PYTHONPATH": str(root / "src")}
        rc |= subprocess.run([sys.executable, __file__, "--worker", tag],
                             env=env, cwd=root, timeout=600).returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        if len(sys.argv) < 2:
            sys.exit(__doc__)
        sys.exit(main(sys.argv[1:]))
