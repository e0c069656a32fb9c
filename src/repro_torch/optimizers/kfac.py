"""K-FAC as a staged pipeline (paper Algorithm 2); mirrors
``repro/optimizers/kfac.py`` for ``inv_mode="blkdiag"``, ``"tridiag"``
(S4.3, on chain models: ``core/tridiag.py``) and ``"eigen"`` (EKFAC),
``refresh_mode="serial"`` or ``"staggered"`` (the legacy
``staggered_inverse=True`` too), τ1-subsampled statistics and
``stats_period``, with the exact-F re-scaling (``use_rescale=True``) or the
fused fixed-lr chain (``use_rescale=False``), and the statistics
contracted inside the passes (``fused_stats=True``, ``core/fused.py``; on
an LM only whisper's two conv stems are eligible, as in the reference).
Models: the MLP autoencoders, Bernoulli or Gaussian, and the conv
classifier, categorical (``core/fisher.py::quad_logits``), and the LM
(``quad_lm``; trained so far: whisper, smollm, llama3.2 and gemma2, whose
d_ff sides are block-diagonal, in every mode above;
``inv_mode="tridiag"`` on a model without
``layer_order``, an LM or the conv classifier, runs the block-diagonal
path, as in the reference).  The reference is functional; here a
statistics pass, a refresh or an EKFAC rescale writes its factors,
inverses or eigen states over a set the engine wrote before
(:class:`Written`), so that a trainer holding the old
state does not hold a second set (full-width llama3.2-1b's are 14.3 GiB
each).
Parameters are nested trees (the LM's stacked ``blocks``),
each tagged weight addressed by its block's ``param_path``; an untagged
parameter (a norm scale) gets the reference's diagonal curvature, the
decayed squared gradient, and is preconditioned by ``g / (diag + λ + η)``.

:class:`KFACEngine` holds the stage functions, each a ``state -> state`` map
over :class:`~repro_torch.core.transform.KFACState`:

  ``stats_grads``       every ``stats_period``-th step: gradients on the
                        true labels, then the model-sampled g statistics on
                        the τ1 sub-batch (``_sub_batch``: every
                        round(1/τ1)-th row), then the decayed factor update
                        (S5) through the ``factor_update`` kernel (with
                        ``fused_stats`` the same kernel contracts each
                        side inside the passes, and the update blends).
  ``grads_only``        the other steps: the gradient pass alone; factors,
                        diagonals and ``k_stats`` stay as they were.
  ``refresh_inverses``  every T3 steps (and the first 3): damped inverses
                        (S4.2/S6.3) — in tridiag mode the per-layer ones and
                        the chain's Ψ/Σ cache — or in eigen mode the factor
                        eigenbases and eigenbasis diagonals;
                        ``refresh_multi`` the three
                        gamma candidates of the S6.6 sweep, stacked on a
                        leading dim instead of JAX's vmap (eigen mode shares
                        one eigh across them).
  ``refresh_subset``    staggered mode, every step after the warmup but the
                        sweep's: one group of ``stagger_groups()`` (LPT
                        bins of the d³ cost, ``distributed/plan.py``), NS
                        hot-started from the held inverses for
                        ``ns_hot_iters`` iterations (eigen: their eigen
                        states).  tridiag's Ψ/Σ cache is not in any group,
                        so under this mode it is recomputed only in the
                        warmup and at γ sweeps, as in the reference.
  ``rescale_step``      eigen mode, every step but the sweep's: the EKFAC
                        diagonal re-estimated from the gradient.
  ``apply_update``      every step: preconditioning (``precondition`` or, in
                        eigen mode, ``rotate_rescale`` kernel; in tridiag
                        mode the chain's Ξᵀ Λ Ξ apply, plain products) with
                        the exact-F re-scaling + momentum 2x2 solve
                        (S6.4/S7) and candidate selection by M(delta).
  ``apply_update_fused`` every step when ``use_rescale=False``: the fixed-lr
                        chain ``D = −lr·Ā⁻¹VḠ⁻¹ + μ·M`` with ``ΣD²`` from the
                        ``update_chain`` kernel (tridiag: the chain's apply,
                        then ``α·U + μ·M`` elementwise, as in the
                        reference), then the KL and norm clips.
  ``lambda_step``       every T1 steps: reduction ratio rho + LM rule (S6.5).

:class:`KFACPipeline` schedules them off the step counter, and :func:`kfac`
wraps the pipeline as an :class:`Optimizer`.  Device scalars (ε, λ, γ, α, μ,
the chosen candidate) stay on the device; the pipeline reads the step
counter, and the T1 stage the finiteness of the new parameters, on the
host, as the reference does.

Random numbers: JAX's stats pass draws its targets from
``fold_in(rng, 1)``.  Here ``rng`` is a callable ``shape -> uniforms`` that
already stands for that stream (the trainer builds it from its ``noise``),
and only the stats pass draws from it, at the sub-batch's shape (the LM's
head turns the uniforms into Gumbel noise, ``models/head.py``; the Gaussian
MLP into normals, ``models/mlp.py``).  ``tau2`` is read by no code, as in
the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import KFACConfig
from repro_torch.core import damping as D
from repro_torch.core import factors as F
from repro_torch.core import fisher as FI
from repro_torch.core.blocks import TridiagChain, build_blocks
from repro_torch.core.transform import KFACState, Optimizer
from repro_torch.distributed.plan import build_plan
from repro_torch.utils import tree as T
from repro_torch.utils.device import resolve_device


def _take(x, idx):
    """``x[idx]`` along dim 0 for a 0-d device index, without a host read."""
    return x.index_select(0, idx.reshape(1)).squeeze(0)


class Written(dict):
    """Factors or inverses (eigen mode: eigen states) by block name, as a
    statistics pass or a refresh of the engine wrote them.  The engine's
    next such write replaces their entries in place, each as soon as its
    new value exists, so that two whole sets never live at once:
    full-width llama3.2-1b's factors are 14.3 GiB, and as much again its
    inverses.  A state that holds this dict sees the new values after
    that write.  Any other dict (``init``'s, a restored or converted
    state's, the γ sweep's pick) is left as it was: the write makes a new
    ``Written``."""


def _written(d) -> Written:
    """Where the engine's next write of a set goes: ``d`` itself if the
    engine wrote it, else a new :class:`Written`."""
    return d if isinstance(d, Written) else Written()


class KFACEngine:
    """model must provide: metas, loss(params, probes, batch, rng, mode),
    make_probes(batch), plus ``hidden``/``head_weight`` (LM) or ``logits``
    (MLP)."""

    def __init__(self, model, cfg: KFACConfig, family: str = "categorical",
                 device="cuda"):
        self.device = resolve_device(device)
        # legacy knob: staggered_inverse=True asked for the round-robin
        # refresh before refresh_mode existed
        self.refresh_mode = ("staggered"
                             if cfg.refresh_mode == "serial"
                             and cfg.staggered_inverse
                             else cfg.refresh_mode)
        if self.refresh_mode not in ("serial", "staggered"):
            raise ValueError(f"unknown refresh_mode {cfg.refresh_mode!r} "
                             "(expected 'serial' or 'staggered')")
        self.model = model
        self.cfg = cfg
        self.family = family
        self.metas = model.metas
        self.is_lm = hasattr(model, "hidden")
        self.tagged = {m.param_path for m in self.metas.values()}
        self.blocks = build_blocks(self.metas, cfg, self.device)
        self.eigen = cfg.inv_mode == "eigen"
        self.tridiag = (cfg.inv_mode == "tridiag"
                        and hasattr(model, "layer_order"))
        self.chain = (TridiagChain(model, cfg, self.device) if self.tridiag
                      else None)
        # backward-pass fusion of the factor statistics (core/fused): the A
        # side rides the forward through the model's contract_map hooks,
        # the G side the backward through the {"gg"} probes (tridiag's
        # chain needs the raw records).  The engine holds its hooks and
        # puts them on the model's maps for its statistics pass alone
        # (``_hooked``), where the reference installs them for good: the
        # model stays as it was, so another engine on it is not affected.
        self.fused = bool(cfg.fused_stats) and not self.tridiag
        self.contract, self.gcontract = {}, {}
        if self.fused:
            from repro_torch.core import fused as FU
            for n, m in self.metas.items():
                if FU.fused_eligible(m):
                    mk = (FU.conv_a_contract if m.kind == "conv"
                          else FU.dense_a_contract)
                    self.contract[n] = mk(m)
                    self.gcontract[n] = FU.g_contract(m)
        self.fused_names = set(self.contract)

    def n_tokens(self, batch) -> int:
        """The global N that normalizes every factor: the batch size, or an
        LM's decoder tokens B·T (the encoder's and the conv stem's factors
        too, as in the reference)."""
        if not self.is_lm:
            return int(batch["x"].shape[0])
        b, t = batch["tokens"].shape
        return int(b * t)

    @contextlib.contextmanager
    def _hooked(self):
        """The fused layers' contraction hooks on the model's maps for the
        forward of one statistics pass (the G hooks ride its autograd graph
        into the backward); the maps are put back as they were after."""
        if not self.fused_names:
            yield
            return
        maps = (self.model.contract_map, self.model.gcontract_map)
        saved = [dict(m) for m in maps]
        maps[0].update(self.contract)
        maps[1].update(self.gcontract)
        try:
            yield
        finally:
            for live, old in zip(maps, saved):
                live.clear()
                live.update(old)

    def _probes(self, batch):
        probes = self.model.make_probes(batch)
        if self.fused_names:
            # fused layers swap the (N, d_out) zero probe for a (d_out,
            # d_out) one whose gradient is the contracted second moment
            from repro_torch.core import fused as FU
            dev = T.tree_leaves(batch)[0].device
            for n in self.fused_names:
                probes[n] = FU.gg_probe(self.metas[n], dev)
        return probes

    def _is_tagged(self, path) -> bool:
        return tuple(path) in self.tagged

    def _scalar(self, v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def init(self, params, batch) -> KFACState:
        factors = {name: blk.init_factors()
                   for name, blk in self.blocks.items()}
        inv = {name: (blk.eigen_identity() if self.eigen
                      else blk.identity_inverse())
               for name, blk in self.blocks.items()}
        if self.chain is not None:
            factors[TridiagChain.CROSS] = self.chain.init_factors()
            inv[TridiagChain.TRI] = self.chain.identity_inverse()
        # diagonal curvature of the untagged params; the reference keeps an
        # empty placeholder for every tagged one
        diag = T.tree_map_with_path(
            lambda path, p: (torch.zeros(0, device=self.device)
                             if self._is_tagged(path)
                             else torch.zeros_like(p, dtype=torch.float32)),
            params)
        cfg = self.cfg
        return KFACState(
            step=self._scalar(0, torch.int32),
            k_stats=self._scalar(0, torch.int32),
            lam=self._scalar(cfg.lambda_init),
            gamma=self._scalar(math.sqrt(cfg.lambda_init + cfg.eta)),
            factors=factors,
            inv=inv,
            diag=diag,
            delta0=T.tree_map(lambda p: torch.zeros_like(p,
                                                         dtype=torch.float32),
                              params),
            m_delta=self._scalar(-1.0),
            loss_prev=self._scalar(0.0),
            staleness=self._scalar(0, torch.int32),
            inv_pending=None,
        )

    # ------------------------------------------------------------------
    # stats + grads: a full-batch gradient pass, plus a τ1-subsampled
    # model-sampled-target pass for the factor statistics that
    # differentiates only w.r.t. the probes (parameters detached), so its
    # backward does no dW products.
    # ------------------------------------------------------------------
    def _sub_batch(self, batch):
        """Every round(1/τ1)-th row of every batch leaf (dim 0), as views;
        the kernels' wrappers copy what they read to contiguous memory."""
        stride = max(1, round(1.0 / self.cfg.tau1))
        if stride == 1:
            return batch
        return T.tree_map(lambda x: x[::stride], batch)

    def _grads(self, params, batch):
        """The gradient pass on the full batch (plain mode): (loss, grads,
        the model's metrics, detached)."""
        p1 = T.tree_map(lambda v: v.detach().requires_grad_(True), params)
        (lt, _), aux = self.model.loss(p1, None, batch, None, mode="plain")
        grads = T.tree_unflatten_like(params, torch.autograd.grad(
            lt, T.tree_leaves(p1)))
        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        return lt.detach(), grads, metrics

    def stats_grads(self, state: KFACState, params, batch, rng):
        # ---- pass 1: gradients on the full batch (plain mode) ----
        lt, grads, metrics = self._grads(params, batch)

        # ---- pass 2: τ1-subsampled statistics with sampled targets ----
        sub = self._sub_batch(batch)
        probes = self._probes(sub)
        n = self.n_tokens(sub)
        frozen = T.tree_map(torch.Tensor.detach, params)
        with self._hooked():
            (_, ls), aux = self.model.loss(frozen, probes, sub, rng,
                                           mode="collect")
        # a fused layer's probe is {"gg": ...}; its gradient comes back so
        leaves = [p["gg"] if isinstance(p, dict) else p
                  for p in probes.values()]
        gprobes = {name: ({"gg": g} if isinstance(p, dict) else g)
                   for (name, p), g in zip(
                       probes.items(), torch.autograd.grad(ls, leaves))}
        recs = aux["recs"]

        k = state.k_stats + 1
        eps = F.decay_eps(k, self.cfg.decay_cap)
        # block by block over the old factors where they are Written
        old = state.factors
        factors = _written(old)
        for name, blk in self.blocks.items():
            factors[name] = blk.update_factors(old[name], recs[name],
                                               gprobes.get(name), n, eps)
        if self.chain is not None:
            cross = TridiagChain.CROSS
            factors[cross] = self.chain.update_factors(
                old[cross], recs, gprobes, n, eps)

        # diagonal running curvature of the untagged params: squared
        # gradients (the norm scales, well under 1% of an LM's parameters)
        diag = T.tree_map_with_path(
            lambda path, g, old: (old if self._is_tagged(path)
                                  else eps * old
                                  + (1.0 - eps) * torch.square(g.float())),
            grads, state.diag)

        state = state.replace(factors=factors, diag=diag, k_stats=k,
                              loss_prev=lt)
        return state, grads, dict(metrics, loss_sampled=ls.detach())

    def grads_only(self, state: KFACState, params, batch, rng):
        """The gradient pass without the statistics pass (the steps that
        ``stats_period`` skips): no target is drawn, and the factors,
        diagonals and ``k_stats`` stay as they were."""
        lt, grads, metrics = self._grads(params, batch)
        return state.replace(loss_prev=lt), grads, metrics

    # ------------------------------------------------------------------
    # inverses
    # ------------------------------------------------------------------
    def _inverses_for(self, factors, gamma, prev=None, out=None):
        """Every block's inverses (eigen mode: eigen states) into ``out``
        (a new dict by default), block by block; ``prev`` holds the NS hot
        starts.  ``out`` may be ``prev`` itself: each block reads only its
        own factors and its own previous inverse, so an entry is replaced
        only after its one reader is done with it."""
        cfg = self.cfg
        out = {} if out is None else out
        for name, blk in self.blocks.items():
            if self.eigen:
                out[name] = blk.eigen_state(factors[name], gamma)
                continue
            out[name] = blk.damped_inverse(
                factors[name], gamma, method=cfg.inverse_method,
                iters=cfg.ns_iters,
                prev=None if prev is None else prev.get(name))
        if self.chain is not None:
            # the per-layer inverses stay in the state as in the reference,
            # though the chain's apply reads only its own cache
            out[TridiagChain.TRI] = self.chain.damped_inverse(factors, gamma)
        return out

    def refresh_inverses(self, state: KFACState, hot: bool = False):
        """Recompute every inverse, over the old ones where ``state.inv``
        is :class:`Written`."""
        inv = state.inv
        prev = inv if (hot and self.cfg.inverse_method == "ns") else None
        return state.replace(inv=self._inverses_for(
            state.factors, state.gamma, prev, out=_written(inv)))

    def refresh_subset(self, state: KFACState, names, hot: bool = True):
        """Staggered refresh: recompute only the named layer blocks, the
        others' inverses (and tridiag's chain cache) kept as they are.  NS
        hot-starts from the held inverses for ``ns_hot_iters`` iterations;
        eigen mode recomputes the blocks' eigen states."""
        cfg = self.cfg
        inv = (state.inv if isinstance(state.inv, Written)
               else Written(state.inv))
        if self.eigen:
            for name in names:
                inv[name] = self.blocks[name].eigen_state(
                    state.factors[name], state.gamma)
            return state.replace(inv=inv)
        prev = state.inv if cfg.inverse_method == "ns" and hot else None
        for name in names:
            inv[name] = self.blocks[name].damped_inverse(
                state.factors[name], state.gamma,
                method=cfg.inverse_method,
                iters=cfg.ns_hot_iters if hot else cfg.ns_iters,
                prev=None if prev is None else prev.get(name))
        return state.replace(inv=inv)

    def stagger_groups(self) -> List[List[str]]:
        """The layer names in T3 staggered-refresh groups, bin-packed by the
        d³ inversion cost model (``distributed/plan.py``), so each step's
        share of the refresh work is even."""
        return build_plan(self.blocks, max(1, self.cfg.t3)).groups()

    def refresh_multi(self, state: KFACState):
        """Inverses for the 3 gamma candidates (S6.6), stacked on a leading
        dim of 3 (the reference vmaps over the candidates; tridiag's cache
        too).  Eigen mode shares one eigendecomposition across the
        candidates: only the damp diagonal depends on gamma."""
        gammas = D.gamma_candidates(state.gamma, self._omega2())
        if self.eigen:
            return gammas, {name: blk.eigen_state_multi(state.factors[name],
                                                        gammas)
                            for name, blk in self.blocks.items()}
        return gammas, self._inverses_for(state.factors, gammas)

    def rescale_step(self, state: KFACState, grads):
        """Eigen mode, every step: re-estimate each block's eigenbasis
        second-moment diagonal from the current (unregularized) gradient;
        the bases stay on the T3 schedule.  No-op in blkdiag mode."""
        if not self.eigen:
            return state
        eps = self._scalar(self.cfg.eigen_decay)
        old = state.inv
        inv = _written(old)
        for name, blk in self.blocks.items():
            inv[name] = blk.rescale_step(
                old[name], T.get_path(grads, blk.meta.param_path), eps)
        return state.replace(inv=inv)

    def _omega1(self):
        return float(self.cfg.omega1_base ** self.cfg.t1)

    def _omega2(self):
        return float(math.sqrt(self.cfg.omega2_base) ** self.cfg.t2)

    # ------------------------------------------------------------------
    # preconditioning
    # ------------------------------------------------------------------
    def _precondition(self, grads_reg, inv, state: KFACState):
        lam_eta = state.lam + self.cfg.eta
        # untagged params: diagonal curvature
        out = T.tree_map_with_path(
            lambda path, g, d: (g if self._is_tagged(path)
                                else g / (d + lam_eta)),
            grads_reg, state.diag)
        if self.chain is not None:
            for name, u in self._chain_apply(grads_reg, inv).items():
                out = T.set_path(out, self.metas[name].param_path, u)
            return T.tree_scale(out, -1.0)
        for name, blk in self.blocks.items():
            path = blk.meta.param_path
            v = T.get_path(grads_reg, path)
            u = (blk.precondition_eigen(inv[name], v) if self.eigen
                 else blk.precondition(inv[name], v))
            out = T.set_path(out, path, u)
        return T.tree_scale(out, -1.0)

    def _chain_apply(self, grads_reg, inv):
        """The tridiagonal ``U = F̂⁻¹ V`` of every chain layer, by name."""
        vs = {name: T.get_path(grads_reg, self.metas[name].param_path)
              for name in self.model.layer_order}
        return self.chain.precondition(inv[TridiagChain.TRI], vs)

    # ------------------------------------------------------------------
    # update: precondition fused with rescale + momentum + candidate select
    # ------------------------------------------------------------------
    def apply_update(self, state: KFACState, params, grads, batch, rng, *,
                     cand_inv: Optional[List] = None, gammas=None):
        """cand_inv: list of inverse dicts (candidates); default state.inv.
        Returns (params', state', metrics)."""
        cfg = self.cfg
        invs = cand_inv if cand_inv is not None else [state.inv]
        nc = len(invs)
        grads_reg = T.tree_axpy(cfg.eta, T.tree_map(torch.Tensor.float, params),
                                T.tree_map(torch.Tensor.float, grads))

        deltas = [self._precondition(grads_reg, inv, state) for inv in invs]
        use_mom = cfg.use_momentum
        tangents = deltas + ([state.delta0] if use_mom else [])
        m = len(tangents)

        lam_eta = state.lam + cfg.eta
        if self.is_lm:
            q = FI.quad_lm(self.model, params, batch, tangents)
        else:
            q = FI.quad_logits(lambda p: self.model.logits(p, batch["x"]),
                               params, batch, tangents, self.family)
        dots = torch.stack([torch.stack([T.tree_dot(tangents[i], tangents[j])
                                         for j in range(m)])
                            for i in range(m)])
        q = q + lam_eta * dots
        b = torch.stack([T.tree_dot(grads_reg, t) for t in tangents])

        if use_mom:
            # per candidate c, the 2x2 model over (delta_c, delta0)
            j = m - 1
            q2 = torch.stack([torch.stack([torch.stack([q[c, c], q[c, j]]),
                                           torch.stack([q[j, c], q[j, j]])])
                              for c in range(nc)])
            q2 = q2 + 1e-20 * torch.eye(2, device=q.device)
            b2 = torch.stack([torch.stack([b[c], b[j]]) for c in range(nc)])
            x = -torch.linalg.solve_ex(q2, b2)[0]              # (nc, 2)
            ms = (0.5 * torch.einsum("ci,cij,cj->c", x, q2, x)
                  + torch.sum(b2 * x, dim=-1))
            alphas, mus = x[:, 0], x[:, 1]
        else:
            qd = torch.diagonal(q)[:nc]
            alphas = -b[:nc] / torch.clamp(qd, min=1e-20)
            mus = torch.zeros_like(alphas)
            ms = 0.5 * alphas * alphas * qd + alphas * b[:nc]
        c_star = torch.argmin(ms)
        alpha = _take(alphas, c_star)
        mu = _take(mus, c_star)
        m_delta = _take(ms, c_star)

        # select the winning candidate's delta (and inverses / gamma)
        if nc == 1:
            delta_sel, inv_sel, gamma_new = deltas[0], invs[0], state.gamma
        else:
            pick = lambda *xs: _take(torch.stack(xs), c_star)
            delta_sel = T.tree_map(pick, *deltas)
            inv_sel = T.tree_map(pick, *invs)
            gamma_new = _take(gammas, c_star)

        delta = T.tree_scale(delta_sel, alpha)
        if use_mom:
            delta = T.tree_axpy(mu, state.delta0, delta)
        new_params = T.tree_map(lambda p, d: p + d.to(p.dtype), params, delta)

        state = state.replace(step=state.step + 1, delta0=delta,
                              m_delta=m_delta, inv=inv_sel, gamma=gamma_new)
        metrics = {
            "alpha": alpha, "mu": mu, "m_delta": m_delta,
            "gamma": gamma_new, "lam": state.lam,
            "grad_norm": torch.sqrt(T.tree_sqnorm(grads_reg)),
            "delta_norm": torch.sqrt(T.tree_sqnorm(delta)),
        }
        return new_params, state, metrics

    # ------------------------------------------------------------------
    # fused fixed-lr update chain: precondition + momentum + global clip
    # ------------------------------------------------------------------
    def apply_update_fused(self, state: KFACState, params, grads, batch,
                           rng, *, inv_override=None, gamma_override=None):
        """The ``use_rescale=False`` path as one stage: per block
        ``D = −lr·(Ā⁻¹ V G⁻¹) + μ·M`` together with ``Σ D²`` from one
        ``precond_momentum`` call (the ``update_chain`` kernel on the card),
        so the clips fold into the parameter apply without re-reading the
        update.  ``delta0`` keeps the pre-clip velocity.  On T2 sweep steps
        the caller passes candidate 0's inverses and gamma.
        Returns (params', state', metrics)."""
        cfg = self.cfg
        inv = inv_override if inv_override is not None else state.inv
        gamma_new = (gamma_override if gamma_override is not None
                     else state.gamma)
        alpha = -self._scalar(cfg.fixed_lr)
        mu = self._scalar(cfg.fixed_momentum)
        grads_reg = T.tree_axpy(cfg.eta, T.tree_map(torch.Tensor.float, params),
                                T.tree_map(torch.Tensor.float, grads))
        lam_eta = state.lam + cfg.eta
        sqs = []

        # untagged params: diagonal curvature, axpy'd in the same traversal
        def leaf(path, g, dd, mom):
            if self._is_tagged(path):
                return mom            # overwritten by the block loop below
            d = alpha * (g / (dd + lam_eta)) + mu * mom
            sqs.append(torch.sum(d * d))
            return d

        vel = T.tree_map_with_path(leaf, grads_reg, state.diag, state.delta0)
        # tridiag: the chain's apply, then alpha·U + mu·M elementwise with
        # ΣD² per leaf (no update_chain launch, as in the reference)
        us = (self._chain_apply(grads_reg, inv) if self.chain is not None
              else None)
        for name, blk in self.blocks.items():
            path = blk.meta.param_path
            mom = T.get_path(state.delta0, path)
            if us is None:
                d, sq = blk.precond_momentum(
                    inv[name], T.get_path(grads_reg, path), mom, alpha, mu,
                    eigen=self.eigen)
            else:
                d = alpha * us[name].float() + mu * mom
                sq = torch.sum(d * d)
            sqs.append(sq)
            vel = T.set_path(vel, path, d)
        norm = torch.sqrt(sum(sqs))
        clip = cfg.kl_clip > 0 or cfg.clip_delta_norm > 0
        factor = self._scalar(1.0)
        if cfg.kl_clip > 0:
            # trust region on the Fisher quadratic of the applied step: vel
            # carries -lr, so |velᵀ∇| ≈ lr²·ΔᵀFΔ and
            # ν = min(1, sqrt(kl_clip / |velᵀ∇|))
            quad = torch.abs(T.tree_dot(vel, grads_reg))
            factor = factor * torch.clamp(
                torch.sqrt(cfg.kl_clip / torch.clamp(quad, min=1e-20)),
                max=1.0)
        if cfg.clip_delta_norm > 0:
            factor = factor * torch.clamp(
                cfg.clip_delta_norm / torch.clamp(norm, min=1e-20), max=1.0)
        if clip:
            new_params = T.tree_map(lambda p, d: p + (factor * d).to(p.dtype),
                                    params, vel)
            delta_norm = factor * norm
        else:
            new_params = T.tree_map(lambda p, d: p + d.to(p.dtype), params,
                                    vel)
            delta_norm = norm

        m_delta = self._scalar(-1.0)
        state = state.replace(step=state.step + 1, delta0=vel,
                              m_delta=m_delta, inv=inv, gamma=gamma_new)
        metrics = {
            "alpha": self._scalar(cfg.fixed_lr), "mu": mu,
            "m_delta": m_delta, "gamma": gamma_new, "lam": state.lam,
            "grad_norm": torch.sqrt(T.tree_sqnorm(grads_reg)),
            "delta_norm": delta_norm,
        }
        if clip:
            metrics["nu"] = factor       # the applied clip factor (1 = none)
        return new_params, state, metrics

    # ------------------------------------------------------------------
    # lambda adaptation (S6.5)
    # ------------------------------------------------------------------
    def lambda_step(self, state: KFACState, new_params, batch, rng):
        (l_new, _), _ = self.model.loss(new_params, None, batch, None,
                                        mode="plain")
        rho = (l_new - state.loss_prev) / torch.clamp(state.m_delta,
                                                       max=-1e-20)
        lam = D.lambda_update(state.lam, rho, self._omega1())
        return state.replace(lam=lam), rho


# ---------------------------------------------------------------------------
# the pipeline: stages + schedule -> Optimizer(init, update, reject)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepContext:
    """Mutable per-step scratch the stages thread their work through."""

    step: int
    warmup: bool
    state: KFACState
    params: Any
    batch: Any
    rng: Any
    grads: Any = None
    new_params: Any = None
    candidates: Any = None          # (gammas, stacked inv3) on T2 steps
    metrics: dict = dataclasses.field(default_factory=dict)


class Stage(NamedTuple):
    name: str
    run: Callable[[StepContext], None]


class KFACPipeline:
    """Drives one optimizer step as an ordered list of named stages, each
    with its own schedule predicate read off the step counter."""

    def __init__(self, engine: KFACEngine):
        self.engine = engine
        self._start: Optional[int] = None
        # staggered mode: the blocks of each of the T3 refresh groups
        self._groups = (engine.stagger_groups()
                        if engine.refresh_mode == "staggered" else None)
        if engine.cfg.use_rescale:
            # precondition is fused into the quadratic-model stage: the
            # M(delta) solve needs every candidate's preconditioned delta
            update_stage = Stage("precondition+quadratic_model_lr_momentum",
                                 self._stage_quadratic)
        else:
            # fixed-lr path: precondition + momentum + clips as one stage;
            # on T2 steps the gamma sweep keeps candidate 0
            update_stage = Stage("fused_precondition_momentum_clip",
                                 self._stage_fused)
        # eigen mode re-estimates the EKFAC diagonal every step
        rescale = ([Stage("eigen_rescale", self._stage_eigen_rescale)]
                   if engine.eigen else [])
        self.stages = [
            Stage("estimate_stats", self._stage_estimate_stats),
            Stage("scheduled_inverse_refresh", self._stage_refresh),
            *rescale,
            update_stage,
            Stage("adapt_lambda", self._stage_adapt_lambda),
        ]

    # -- stages --------------------------------------------------------
    def _stage_estimate_stats(self, ctx: StepContext):
        if ctx.grads is not None:
            raise ValueError(
                "kfac computes its own gradients (the statistics pass "
                "shares the forward with the gradient pass) — call "
                "update(None, state, params, batch, rng)")
        if ctx.step % self.engine.cfg.stats_period == 0:
            stage = self.engine.stats_grads
        else:
            stage = self.engine.grads_only     # stats skipped this step
        ctx.state, ctx.grads, metrics = stage(ctx.state, ctx.params,
                                              ctx.batch, ctx.rng)
        ctx.metrics.update(metrics)

    def _stage_refresh(self, ctx: StepContext):
        cfg = self.engine.cfg
        if cfg.t2 > 0 and ctx.step > 0 and ctx.step % cfg.t2 == 0:
            # gamma sweep (S6.6): stacked candidate inverses; selection
            # happens inside the quadratic-model stage
            ctx.candidates = self.engine.refresh_multi(ctx.state)
        elif self._groups is not None and not ctx.warmup:
            # staggered: one group of blocks a step, balanced by d³ cost
            ctx.state = self.engine.refresh_subset(
                ctx.state, self._groups[ctx.step % cfg.t3])
        elif ctx.warmup or ctx.step % cfg.t3 == 0:
            ctx.state = self.engine.refresh_inverses(ctx.state, hot=True)

    def _stage_eigen_rescale(self, ctx: StepContext):
        if ctx.candidates is None:
            # re-estimated in the (amortized) eigenbases; the sweep step
            # keeps its fresh states
            ctx.state = self.engine.rescale_step(ctx.state, ctx.grads)

    def _stage_fused(self, ctx: StepContext):
        eng = self.engine
        if ctx.candidates is not None:
            gs, i3 = ctx.candidates
            ctx.new_params, ctx.state, um = eng.apply_update_fused(
                ctx.state, ctx.params, ctx.grads, ctx.batch, ctx.rng,
                inv_override=T.tree_map(lambda x: x[0], i3),
                gamma_override=gs[0])
        else:
            ctx.new_params, ctx.state, um = eng.apply_update_fused(
                ctx.state, ctx.params, ctx.grads, ctx.batch, ctx.rng)
        ctx.metrics.update(um)

    def _stage_quadratic(self, ctx: StepContext):
        eng = self.engine
        if ctx.candidates is not None:
            gs, i3 = ctx.candidates
            cand = [T.tree_map(lambda x, c=c: x[c], i3)
                    for c in range(gs.shape[0])]
            ctx.new_params, ctx.state, um = eng.apply_update(
                ctx.state, ctx.params, ctx.grads, ctx.batch, ctx.rng,
                cand_inv=cand, gammas=gs)
        else:
            ctx.new_params, ctx.state, um = eng.apply_update(
                ctx.state, ctx.params, ctx.grads, ctx.batch, ctx.rng)
        ctx.metrics.update(um)

    def _stage_adapt_lambda(self, ctx: StepContext):
        cfg = self.engine.cfg
        if cfg.t1 > 0 and (ctx.step + 1) % cfg.t1 == 0:
            # a non-finite update will be rejected by the trainer: evaluate
            # rho at the params it will actually keep
            target = (ctx.new_params if bool(T.tree_isfinite(ctx.new_params))
                      else ctx.params)
            ctx.state, rho = self.engine.lambda_step(ctx.state, target,
                                                     ctx.batch, ctx.rng)
            ctx.metrics["rho"] = rho

    # -- Optimizer protocol --------------------------------------------
    def init(self, params, batch) -> KFACState:
        self._start = None            # new run: re-arm the warmup refreshes
        return self.engine.init(params, batch)

    def update(self, grads, state: KFACState, params, batch, rng):
        step = int(state.step)        # schedule off the state, not a loop var
        if self._start is None:
            self._start = step
        ctx = StepContext(step=step, warmup=step - self._start < 3,
                          state=state, params=params, batch=batch, rng=rng,
                          grads=grads)
        for stage in self.stages:
            stage.run(ctx)
        return ctx.new_params, ctx.state, ctx.metrics

    def reject(self, state: KFACState) -> KFACState:
        """Non-finite update was skipped: raise damping, drop momentum."""
        return state.replace(lam=state.lam * 4.0,
                             delta0=T.tree_zeros_like(state.delta0))


def kfac(model=None, cfg: Optional[KFACConfig] = None,
         family: str = "categorical", *, engine: Optional[KFACEngine] = None,
         device="cuda") -> Optimizer:
    """Build the K-FAC optimizer pipeline as an ``Optimizer``.

        opt = kfac(model, KFACConfig(...), family="bernoulli", device="cuda")
        state = opt.init(params, batch)
        new_params, state, metrics = opt.update(None, state, params,
                                                batch, uniforms)
    """
    eng = engine if engine is not None else KFACEngine(
        model, cfg or KFACConfig(), family, device)
    pipe = KFACPipeline(eng)
    return Optimizer(init=pipe.init, update=pipe.update, reject=pipe.reject,
                     engine=eng, name=f"kfac_{eng.cfg.inv_mode}")
