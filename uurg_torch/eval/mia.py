"""Membership-inference attacks, with their own solvers.

Port of ``uurg_tpu/eval/mia.py``:
- ``membership_attack_prob``: the logistic-regression attack on entropy or
  modified-entropy features (Classification/evaluation/mia.py:72-87).
- ``svc_mia``: the RBF support-vector shadow-model attack over confidence,
  entropy and modified-entropy features (Classification/evaluation/
  svc_mia.py:44-143).

The JAX package fits scikit-learn's ``LogisticRegression(class_weight=
"balanced", solver="lbfgs")`` and ``SVC(C=3, gamma="auto", kernel="rbf")``.
The port needs no scikit-learn; it solves the same two problems:

- :func:`fit_logistic`: L2 logistic regression with C = 1, the intercept
  unpenalised, balanced sample weights, the objective scaled as
  scikit-learn scales it (the weighted mean loss plus ``||w||^2 / (2 C
  sum(weights))``) and minimised by ``scipy.optimize.minimize`` with
  L-BFGS-B from zero at scikit-learn's settings (gtol 1e-4, ftol 64 eps,
  at most 100 iterations, 50 line-search steps).
- :func:`fit_svc`: the C-SVC dual by SMO as libsvm solves it: the
  second-order working-set choice, tolerance 1e-3 on the maximal KKT
  violation, kernel rows rounded to float32 as libsvm caches them, and
  libsvm's intercept (the mean of ``y G`` over free vectors, else the
  midpoint of its bounds). libsvm also shrinks the active set, which
  changes the path and not the optimum; this solver does not.

Inputs are (softmax probs, labels) numpy arrays: inference is the caller's
(``Classifier.collect_logits``), so these evaluators are host code.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
from scipy.special import expit

from uurg_torch.eval.features import confidence, entropy, m_entropy

_TAU = 1e-12            # libsvm's floor on a non-positive curvature
# scikit-learn's settings in the JAX package's two attacks
_LR_C, _LR_TOL, _LR_MAX_ITER = 1.0, 1e-4, 100
_SVC_C, _SVC_TOL = 3.0, 1e-3
_SVC_CACHE_ROWS = 4096  # kernel rows kept, the last working-set indices'


def _two_classes(y: np.ndarray) -> np.ndarray:
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError(f"the attack needs samples of two classes; got "
                         f"only {classes.tolist()}")
    return classes


def fit_logistic(x: np.ndarray, y: np.ndarray):
    """Binary L2 logistic regression with balanced class weights.
    ``x`` is (n, d), ``y`` any two labels. Returns ``(coef (d,), intercept,
    classes)``; a sample is ``classes[1]`` where ``x @ coef + intercept >
    0``."""
    x = np.asarray(x)
    x = x if x.dtype in (np.float32, np.float64) else x.astype(np.float64)
    classes = _two_classes(y)
    pos = y == classes[1]
    counts = np.array([np.sum(~pos), np.sum(pos)])
    sw = (len(y) / (2.0 * counts)).astype(x.dtype)[pos.astype(np.int64)]
    target = pos.astype(x.dtype)
    sw_sum = float(np.sum(sw))
    l2 = 1.0 / (_LR_C * sw_sum)
    d = x.shape[1]

    def loss_grad(w):
        raw = x @ w[:d] + w[d]
        loss = float(np.sum(sw * (np.logaddexp(0.0, raw) - target * raw))
                     / sw_sum) + 0.5 * l2 * float(w[:d] @ w[:d])
        gp = sw * (expit(raw) - target) / sw_sum
        return loss, np.concatenate([x.T @ gp + l2 * w[:d], [gp.sum()]])

    res = scipy.optimize.minimize(
        loss_grad, np.zeros(d + 1, x.dtype), method="L-BFGS-B", jac=True,
        options={"maxiter": _LR_MAX_ITER, "maxls": 50, "gtol": _LR_TOL,
                 "ftol": 64 * np.finfo(float).eps})
    return res.x[:d], float(res.x[d]), classes


def fit_svc(x: np.ndarray, y: np.ndarray):
    """C-SVC (C = 3) with the RBF kernel ``exp(-gamma |a - b|^2)``, gamma =
    1 / n_features (scikit-learn's "auto"), solved by SMO. Returns a
    ``predict(z) -> labels`` function."""
    x = np.asarray(x, np.float64)
    n, d = x.shape
    gamma, C = 1.0 / d, _SVC_C
    classes = _two_classes(y)
    s = np.where(y == classes[0], 1.0, -1.0)     # classes[0] is libsvm's +1
    pos = s > 0
    xsq = np.einsum("ij,ij->i", x, x)
    cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def kernel(a, asq, b, bsq):
        return np.exp(-gamma * (asq[:, None] + bsq[None, :] - 2.0 * a @ b.T))

    def row(i):
        """(K(i, :) rounded to float32 as libsvm caches it, the curvature
        K(i, i) + K(:, :) - 2 K(i, :) with libsvm's floor)."""
        hit = cache.get(i)
        if hit is None:
            k = kernel(x[i:i + 1], xsq[i:i + 1], x, xsq)[0]
            k = k.astype(np.float32).astype(np.float64)
            quad = 2.0 - 2.0 * k                      # K(i, i) = 1
            hit = (k, np.where(quad > 0, quad, _TAU))
            if len(cache) >= _SVC_CACHE_ROWS:
                del cache[next(iter(cache))]
            cache[i] = hit
        return hit

    # m = -y G, G the dual gradient (G = -1 at alpha = 0); "up" and "low"
    # are libsvm's I_up and I_low
    alpha = np.zeros(n)
    m = s.copy()
    up, low = pos.copy(), ~pos

    def status(t):
        up[t] = alpha[t] < C if pos[t] else alpha[t] > 0
        low[t] = alpha[t] > 0 if pos[t] else alpha[t] < C

    for _ in range(max(10_000_000, 100 * n)):
        # working set, second order (Fan, Chen and Lin 2005); ties go to the
        # last index, as libsvm's >= and <= scans leave them
        cand = np.where(up, m, -np.inf)
        i = n - 1 - int(np.argmax(cand[::-1]))
        if not up[i] or not low.any():
            break
        g_max = m[i]
        g_max2 = -np.min(np.where(low, m, np.inf))
        if g_max + g_max2 < _SVC_TOL:
            break
        ki, quad_i = row(i)
        diff = g_max - m
        score = np.where(low & (diff > 0), diff * diff / quad_i, -1.0)
        j = n - 1 - int(np.argmax(score[::-1]))
        if score[j] < 0:
            break
        kj, _ = row(j)
        ai, aj = alpha[i], alpha[j]
        gi, gj = -s[i] * m[i], -s[j] * m[j]
        q = quad_i[j]
        if s[i] != s[j]:
            delta = (-gi - gj) / q
            dif = ai - aj
            ni, nj = ai + delta, aj + delta
            if dif > 0:
                if nj < 0:
                    nj, ni = 0.0, dif
            elif ni < 0:
                ni, nj = 0.0, -dif
            if dif > 0:
                if ni > C:
                    ni, nj = C, C - dif
            elif nj > C:
                nj, ni = C, C + dif
        else:
            delta = (gi - gj) / q
            tot = ai + aj
            ni, nj = ai - delta, aj + delta
            if tot > C:
                if ni > C:
                    ni, nj = C, tot - C
            elif nj < 0:
                nj, ni = 0.0, tot
            if tot > C:
                if nj > C:
                    nj, ni = C, tot - C
            elif ni < 0:
                ni, nj = 0.0, tot
        alpha[i], alpha[j] = ni, nj
        m -= ki * (s[i] * (ni - ai)) + kj * (s[j] * (nj - aj))
        status(i)
        status(j)

    # libsvm's rho: mean of y G over free vectors, else the bounds' midpoint
    yg = -m
    at_ub, at_lb = alpha >= C, alpha <= 0
    free = ~at_ub & ~at_lb
    if free.any():
        rho = float(yg[free].mean())
    else:
        ub_set = (at_ub & ~pos) | (at_lb & pos)
        lb_set = (at_ub & pos) | (at_lb & ~pos)
        ub = yg[ub_set].min() if ub_set.any() else np.inf
        lb = yg[lb_set].max() if lb_set.any() else -np.inf
        rho = float((ub + lb) / 2.0)
    sv = alpha > 0
    coef, xs, xs_sq = (alpha * s)[sv], x[sv], xsq[sv]

    def predict(z: np.ndarray, chunk: int = 1024) -> np.ndarray:
        z = np.asarray(z, np.float64).reshape(len(z), -1)
        zsq = np.einsum("ij,ij->i", z, z)
        dec = np.concatenate([
            kernel(z[k:k + chunk], zsq[k:k + chunk], xs, xs_sq) @ coef - rho
            for k in range(0, len(z), chunk)]) if len(z) else np.zeros(0)
        return np.where(dec > 0, classes[0], classes[1])

    return predict


def membership_attack_prob(
    retain_probs: np.ndarray,
    retain_labels: np.ndarray,
    forget_probs: np.ndarray,
    forget_labels: np.ndarray,
    test_probs: np.ndarray,
    test_labels: np.ndarray,
    metric: str = "entropy",
) -> float:
    """Fraction of forget samples the attacker still classifies as members.

    Attacker: balanced logistic regression trained on retain (member) vs
    test (non-member) features."""
    if metric == "entropy":
        feat = lambda p, y: entropy(p)  # noqa: E731
    elif metric == "m_entropy":
        feat = m_entropy
    else:
        raise NotImplementedError(metric)

    x_r = np.concatenate([feat(retain_probs, retain_labels),
                          feat(test_probs, test_labels)]).reshape(-1, 1)
    y_r = np.concatenate([np.ones(len(retain_probs)),
                          np.zeros(len(test_probs))])
    x_f = feat(forget_probs, forget_labels).reshape(-1, 1)
    coef, intercept, classes = fit_logistic(x_r, y_r)
    pred = classes[(x_f @ coef + intercept > 0).astype(np.int64)]
    return float(pred.mean())


def _svc_fit_predict(shadow_train, shadow_test, target_train,
                     target_test) -> float:
    x = np.concatenate([shadow_train, shadow_test]).reshape(
        len(shadow_train) + len(shadow_test), -1)
    y = np.concatenate([np.ones(len(shadow_train)),
                        np.zeros(len(shadow_test))])
    predict = fit_svc(x, y)
    accs = []
    if len(target_train):
        accs.append(predict(target_train).mean())
    if len(target_test):
        accs.append(1 - predict(target_test).mean())
    return float(np.mean(accs))


def svc_mia(
    shadow_train: tuple[np.ndarray, np.ndarray],
    shadow_test: tuple[np.ndarray, np.ndarray],
    target_train: tuple[np.ndarray, np.ndarray],
    target_test: tuple[np.ndarray, np.ndarray],
) -> dict:
    """Each argument is (softmax_probs, labels); target_* may be empty.

    Returns {"confidence", "entropy", "m_entropy"} attack accuracies."""
    out = {}
    for name, feat in [
        ("confidence", confidence),
        ("entropy", lambda p, y: entropy(p)),
        ("m_entropy", m_entropy),
    ]:
        out[name] = _svc_fit_predict(
            feat(*shadow_train), feat(*shadow_test),
            feat(*target_train) if len(target_train[0]) else np.zeros((0, 1)),
            feat(*target_test) if len(target_test[0]) else np.zeros((0, 1)),
        )
    return out
