"""The first D+G steps of training, worked out again in plain PyTorch.

Each step takes the configuration's batch of the epoch's shuffled order and
draws from the threefry key ``K_s`` of step ``s`` (``K_0 = fold_in(PRNGKey(seed),
2)``, ``K_{s+1} = child(child(K_s, 0), 0)``):

- the D update: G's noise ``normal(child(child(K_s, 1), 0)) * noise_std``, G in
  eval mode on it with the real batch's labels, D in train mode on the real
  batch (dropout keys below ``child(K_s, 2)``) and on the fakes (below
  ``child(K_s, 3)``), the least-squares loss ``mean((D(real) - 1)^2) +
  mean(D(fake)^2)``, its gradient, one RMSprop update of D;
- the G update from ``K'_s = child(K_s, 0)``: noise from ``child(child(K'_s, 1),
  0)``, G in train mode, D (updated, in train mode, keys below ``child(K'_s,
  3)``) on G's output, the loss ``mean((D(G(z)) - 1)^2)``, its gradient with
  respect to G alone, one RMSprop update of G.

RMSprop as ``torch.optim.RMSprop`` defines it: ``v = 0.99 v + 0.01 g^2``,
``p -= lr g / (sqrt(v) + 1e-8)``.
"""

from __future__ import annotations

import torch

from . import model, rng

ALPHA, EPS = 0.99, 1e-8


def step_key(seed: int, step: int) -> tuple[int, int]:
    k = rng.child(rng.root_key(seed), 2)
    for _ in range(2 * step):
        k = rng.child(k, 0)
    return k


def _rmsprop(params, grads, sq, lr):
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            sq[name].mul_(ALPHA).addcmul_(g, g, value=1 - ALPHA)
            p.sub_(lr * g / (sq[name].sqrt() + EPS))


def run_steps(spec: model.Spec, g_state: dict, d_state: dict, data: torch.Tensor,
              labels: torch.Tensor, rows: list, seed: int, mm=model.matmul,
              half_batch: bool = False, d_after: list | None = None) -> dict:
    """The first ``len(rows)`` D+G steps from the initial weights ``g_state`` and
    ``d_state`` (name to tensor; copied, not changed), on the batches
    ``data[rows[s]]``, ``labels[rows[s]]``. Returns each step's loss parts
    (``losses``: ``[[Dr, Df, G], ...]``), D's first output on the real
    batch, one value a jet (``d_real1``), each leaf's first gradient
    (``grad``: ``{"g": {name: tensor}, "d": ...}``, the gradients of the first
    step's updates), the parameters after each step (``after``, host copies)
    and after the last (``final``). ``half_batch``: a fault, every loss the
    mean over the first half of its rows alone. ``d_after``: a witness, D's
    parameters (name to tensor) to go on from after step ``s``'s D update,
    in place of the reference's own."""
    dev = data.device
    n = spec.num_particles
    gp = {k: v.detach().clone().requires_grad_(True) for k, v in g_state.items()}
    dp = {k: v.detach().clone().requires_grad_(True) for k, v in d_state.items()}
    sq = {"g": {k: torch.zeros_like(v) for k, v in gp.items()},
          "d": {k: torch.zeros_like(v) for k, v in dp.items()}}
    losses, first, after = [], {}, []

    def mse(out, target):
        if half_batch:
            out = out[: out.shape[0] // 2]
        return torch.mean((out - target) ** 2)

    for s, r in enumerate(rows):
        idx = torch.as_tensor(r, dtype=torch.long, device=dev)
        real, lab = data[idx], labels[idx]
        b = real.shape[0]
        k = step_key(seed, s)
        gpar, dpar = model.params_of(gp, "g"), model.params_of(dp, "d")
        noise = rng.normal(rng.at(k, (1, 0)), (b, n, spec.latent), spec.noise_std, dev)
        with torch.no_grad():
            fake = model.generator(gpar, noise, lab, spec, mm)
        d_real = model.discriminator(dpar, real, spec, True, rng.child(k, 2), mm)
        d_fake = model.discriminator(dpar, fake, spec, True, rng.child(k, 3), mm)
        dr, df = mse(d_real, 1.0), mse(d_fake, 0.0)
        grads = torch.autograd.grad(dr + df, list(dp.values()))
        grads = dict(zip(dp, grads))
        if s == 0:
            first["d"] = {k2: v.detach().clone() for k2, v in grads.items()}
            first["d_real1"] = d_real.detach().reshape(-1).cpu()
        _rmsprop(dp, grads, sq["d"], spec.lr_disc)
        if d_after is not None:
            with torch.no_grad():
                for name, v in dp.items():
                    v.copy_(d_after[s][name])

        kg = rng.child(k, 0)
        noise = rng.normal(rng.at(kg, (1, 0)), (b, n, spec.latent), spec.noise_std, dev)
        fake = model.generator(gpar, noise, lab, spec, mm)
        dpar = model.params_of({k2: v.detach() for k2, v in dp.items()}, "d")
        out = model.discriminator(dpar, fake, spec, True, rng.child(kg, 3), mm)
        gl = mse(out, 1.0)
        grads = dict(zip(gp, torch.autograd.grad(gl, list(gp.values()))))
        if s == 0:
            first["g"] = {k2: v.detach().clone() for k2, v in grads.items()}
        _rmsprop(gp, grads, sq["g"], spec.lr_gen)
        losses.append([float(dr.detach()), float(df.detach()), float(gl.detach())])
        after.append({m: {k2: v.detach().to("cpu", copy=True) for k2, v in ps.items()}
                      for m, ps in (("g", gp), ("d", dp))})
        del real, fake, d_real, d_fake, out, grads
    return {"losses": losses, "grad": {m: first[m] for m in ("g", "d")},
            "d_real1": first["d_real1"], "after": after,
            "final": {"g": {k: v.detach() for k, v in gp.items()},
                      "d": {k: v.detach() for k, v in dp.items()}}}
