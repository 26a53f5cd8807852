"""Device-batched trio likelihood scoring: (call, k-mer, scenario) tensors.

The ``simlike`` likelihood model (reference kevlar/simlike.py:99-191)
evaluated for EVERY call in one jitted program: per-k-mer genotype
log-probabilities (log-binomial via ``gammaln`` for absent, normal logpdf
for het/hom), the three composite likelihoods, and the 11-scenario
inheritance max, all batched over a padded ``[N, K]`` bundle tensor.

The host scalar/numpy implementations in :mod:`kevlar_tpu.simlike` remain
the golden reference (they use exact float64 ``math.lgamma``); this path
trades ~1e-6 relative precision (float32 on the device) for device residency and
is opt-in via ``KEVLAR_SIMLIKE_DEVICE=1``.  Parity is pinned in
tests/test_simlike.py (tolerance + rank agreement).
"""

import functools
from math import log

import numpy as np
import jax
import jax.numpy as jnp

# (child, mother, father) genotype index per inheritance scenario
# (reference simlike.py:162-191; same order as simlike.INHERITANCE_SCENARIOS)
_SCENARIOS = np.array([
    (1, 0, 1), (1, 0, 2),
    (1, 1, 0), (1, 1, 1), (1, 1, 2),
    (1, 2, 0), (1, 2, 1),
    (2, 1, 1), (2, 1, 2),
    (2, 2, 1), (2, 2, 2),
], dtype=np.int32)


def _lp_abs(a, refrc, mean, error):
    """Genotype-0 (absent) log-binomial; refrc == 0 means INDEL mode
    (refrabund=1, error*0.01) — reference simlike.py:115-128."""
    indel = refrc == 0
    r = jnp.where(indel, 1.0, refrc)
    err = jnp.where(indel, error * 0.01, error)
    sm = mean * r
    ac = jnp.minimum(a, sm)
    nck = (jax.scipy.special.gammaln(sm + 1.0)
           - jax.scipy.special.gammaln(ac + 1.0)
           - jax.scipy.special.gammaln(sm - ac + 1.0))
    return nck + ac * jnp.log(err) + (sm - ac) * jnp.log1p(-err)


def _lp_norm(a, mu, sd):
    z = (a - mu) / sd
    return -0.5 * z * z - jnp.log(sd) - 0.5 * jnp.log(2.0 * jnp.pi)


@functools.partial(jax.jit, static_argnames=('mean', 'sd', 'error'))
def _score_bundles(case, ctrls, refrc, mask, mean, sd, error):
    """case [N,K]; ctrls [C,N,K]; refrc [N,K] (0 = indel mode);
    mask [N,K] bool -> (lldn, llfp, llih) each [N] float32."""
    m = mask.astype(case.dtype)
    kcount = jnp.sum(m, axis=-1)
    nonempty = kcount > 0

    # LLDN: case het + every control absent (simlike.py:135-148)
    lldn = jnp.sum(_lp_norm(case, mean / 2, sd / 2) * m, axis=-1)
    abs_ctrl = jnp.sum(_lp_abs(ctrls, refrc[None], mean, error) * m[None],
                       axis=-1)  # [C, N]
    lldn = lldn + jnp.sum(abs_ctrl, axis=0)
    lldn = jnp.where(nonempty, lldn, 0.0)

    # LLFP: all samples absent (simlike.py:151-159)
    llfp = jnp.sum(_lp_abs(case, refrc, mean, error) * m, axis=-1) \
        + jnp.sum(abs_ctrl, axis=0)
    llfp = jnp.where(nonempty, llfp, 0.0)

    # LLIH: per-k-mer max over the 11 scenarios; the inheritance scan
    # never passes refrabund (INDEL mode everywhere, simlike.py:162-191)
    people = jnp.concatenate([case[None], ctrls], axis=0)  # [3, N, K]
    zero_refr = jnp.zeros_like(refrc)
    lp = jnp.stack([
        _lp_abs(people, zero_refr[None], mean, error),
        _lp_norm(people, mean / 2, sd / 2),
        _lp_norm(people, mean, sd),
    ], axis=1)  # [3 people, 3 genotypes, N, K]
    scen = jnp.asarray(_SCENARIOS)
    totals = (lp[0, scen[:, 0]] + lp[1, scen[:, 1]] + lp[2, scen[:, 2]]
              + log(1.0 / 15.0))  # [S, N, K]
    best = jnp.max(totals, axis=0)  # [N, K]
    llih = log(15.0 / 11.0) + jnp.sum(best * m, axis=-1)
    llih = jnp.where(nonempty, llih, log(15.0 / 11.0))
    return lldn, llfp, llih


def score_bundles(bundles, mean=30.0, sd=8.0, error=0.001):
    """Score a list of ``_AbundanceBundle``s on device in one dispatch.

    Trio-shaped bundles only (two controls — the inheritance model is
    trio-specific, like the reference's).  Returns float lists
    (lldn, llfp, llih) aligned with ``bundles``.
    """
    N = len(bundles)
    if N == 0:
        return [], [], []
    kmax = max(max((len(b.case) for b in bundles), default=1), 1)
    K = -(-kmax // 32) * 32
    Np = -(-N // 64) * 64
    case = np.zeros((Np, K), np.float32)
    ctrls = np.zeros((2, Np, K), np.float32)
    refrc = np.zeros((Np, K), np.float32)
    mask = np.zeros((Np, K), bool)
    for i, b in enumerate(bundles):
        k = len(b.case)
        if k == 0:
            continue
        case[i, :k] = b.case
        for c in range(2):
            ctrls[c, i, :k] = b.controls[c]
        refrc[i, :k] = [0.0 if x is None else float(x)
                        for x in b.refrcopies]
        mask[i, :k] = True
    lldn, llfp, llih = _score_bundles(
        jnp.asarray(case), jnp.asarray(ctrls), jnp.asarray(refrc),
        jnp.asarray(mask), float(mean), float(sd), float(error))
    return (np.asarray(lldn)[:N].tolist(), np.asarray(llfp)[:N].tolist(),
            np.asarray(llih)[:N].tolist())
