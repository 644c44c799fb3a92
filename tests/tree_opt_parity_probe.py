"""Where the port's single-device tree-mode trajectory leaves JAX's
elementwise gate (tests/test_tp.py:118-139: rtol 1e-3, atol 5e-6).

Runs 3 steps of JAX's tree-mode `Trainer` and of the port's from one set of
weights (tests/test_torch_tp.py's GemNet-Q, batch and TrainConfig) at a
clip setting, and prints, for each element outside the gate after the
steps, its share of the gate, its gradient in both packages at each step
and its unit's AGC ratio ||g||_unit / (clip * max(||p||_unit, 1e-3)) in
both; then how many units AGC clips in each package, and how many sit
within 1e-3 of the threshold. Last, the fp32 error against fp64 of the
radial part of the basis that `mlp_cbf4` takes (`GemNet.cbf_basis`, at the
interaction cutoff), by order l at n = 0, over 1-10 A.

    python tests/tree_opt_parity_probe.py                  # AGC at 1e-3
    python tests/tree_opt_parity_probe.py --no-agc --clip 10
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def trajectories(agc: bool, clip: float, show: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_tp as T
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.training import Trainer, tree_opt
    from test_torch_halo import jax_variables

    jax.config.update("jax_platforms", "cpu")
    variables = T.init_variables()
    jcfg = T.jax_cfg("Q")
    cfg = T.port_cfg(jcfg)
    sd = state_dict_from_jax(variables, cfg)
    batch = T.batch_of(jcfg)
    jv = jax_variables(sd, cfg)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    kw = dict(T.TRAIN, agc=agc, grad_clip_max=clip)
    jt = JaxTrainer(make_model(jcfg), JaxTrainConfig(**kw))
    js = jt.init_state(jv)
    jstep = jt.train_step_fn()
    pt = Trainer(T.port_model(sd, cfg), TrainConfig(**kw))
    ps = pt.init_state()
    pbatch = to_torch(batch, "cpu")

    def port_sd(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return state_dict_from_jax({"params": tree, "scale_factors": jv["scale_factors"]}, cfg)

    jgrad = jax.jit(jax.grad(lambda p: jt._loss_and_metrics(p, js.scales, jbatch)[0]))
    names = [n for n, _ in pt.model.named_parameters()]
    layout = pt.layout

    def ratio(g, p, dims):
        gn = torch.clamp_min(tree_opt.unitwise_norm(g, dims), 1e-6)
        return (gn / (torch.clamp_min(tree_opt.unitwise_norm(p, dims), 1e-3) * clip)).detach()

    history = []
    for _ in range(T.TRAIN_STEPS):
        g_jax, p_jax = port_sd(jgrad(js.params)), port_sd(js.params)
        params = list(pt.model.parameters())
        loss, _ = pt._loss_and_metrics(pbatch, create_graph=True)
        g_port = tree_opt.scale_shared_grads(torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True), layout)
        g_jax = tree_opt.scale_shared_grads([g_jax[n] for n in names], layout)
        history.append({n: (ratio(g_port[i], params[i], layout.unit_dims[i]),
                            ratio(g_jax[i], p_jax[n], layout.unit_dims[i]),
                            g_port[i].detach().clone(), g_jax[i].clone())
                        for i, n in enumerate(names) if not layout.head[i]})
        js, _, _ = jstep(js, jbatch, jnp.float32(1.0))
        ps, _, _ = pt.train_step(ps, pbatch, 1.0)

    port_p = {n: t.detach().clone() for n, t in pt.model.state_dict().items()}
    with pt.weights(ps, use_ema=True):
        port_e = {n: t.detach().clone() for n, t in pt.model.state_dict().items()}
    total = 0
    for what, got, want in (("params", port_p, port_sd(js.params)),
                            ("ema", port_e, port_sd(jt.ema_tree(js)))):
        for n in names:
            a, b = got[n].numpy(), want[n].numpy()
            share = np.abs(a - b) / (5e-6 + 1e-3 * np.abs(b))
            bad = np.argwhere(share > 1)
            total += len(bad)
            if not len(bad):
                continue
            dims = layout.unit_dims[names.index(n)]
            print(f"{what} {n} {tuple(a.shape)}: {len(bad)} outside, worst {share.max():.2f}x "
                  "the gate")
            for e in map(tuple, bad[:show]):
                unit = tuple(0 if d in dims else e[d] for d in range(a.ndim)) if dims else ()
                print(f"  element {e}: port {a[e]:.8e}, jax {b[e]:.8e}")
                for k, rec in enumerate(history):
                    if n not in rec:
                        continue
                    rp, rj, gp, gj = rec[n]
                    print(f"    step {k + 1}: gradient port {gp[e].item():.4e} jax "
                          f"{gj[e].item():.4e} (largest |g| of the tensor {gp.abs().max():.3e});"
                          f" AGC ratio port {rp[unit].item():.6f} jax {rj[unit].item():.6f}")
    print(f"elements outside the gate: {total}")
    for k, rec in enumerate(history):
        port = sum(int((r[0] > 1).sum()) for r in rec.values())
        jaxc = sum(int((r[1] > 1).sum()) for r in rec.values())
        units = sum(r[0].numel() for r in rec.values())
        near = sum(int(((r[0] - 1).abs() < 1e-3).sum()) for r in rec.values())
        print(f"step {k + 1}: AGC {'on' if agc else 'off'} at {clip}; units over the threshold "
              f"port {port}, jax {jaxc} of {units}; within 1e-3 of it {near}")


def basis_precision():
    import torch

    import test_torch_tp as T
    from gemnet_pytorch_tpu_torch.models.basis import CircularBasis

    cfg = T.port_cfg(T.jax_cfg("Q"))
    d = torch.linspace(1.0, 10.0, 10, dtype=torch.float64)
    basis = CircularBasis(cfg.num_spherical, cfg.num_radial, cfg.int_cutoff)
    r32 = basis.rbf_env(d.float(), torch.ones(10)).double()
    r64 = basis.double().rbf_env(d, torch.ones(10, dtype=torch.float64))
    rel = (r32 - r64).abs() / r64.abs().clamp_min(1e-300)
    print(f"fp32 radial basis (cutoff {cfg.int_cutoff} A) against fp64, n = 0, relative error "
          "at d = "
          + ", ".join(f"{x:.1f}" for x in d.tolist()) + " A:")
    for l in range(cfg.num_spherical):
        print(f"  l = {l}: " + " ".join(f"{x:.1e}" for x in rel[:, l, 0].tolist()))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--no-agc", action="store_true", help="the global-norm clip instead of AGC")
    p.add_argument("--clip", type=float, default=1e-3, help="grad_clip_max")
    p.add_argument("--show", type=int, default=2, help="elements printed a tensor")
    args = p.parse_args()
    trajectories(not args.no_agc, args.clip, args.show)
    basis_precision()


if __name__ == "__main__":
    main()
