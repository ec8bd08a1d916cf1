"""GP Bayesian optimization with parallel (constant-liar) asking — the
optimizer class the paper builds its infrastructure around (SigOpt serves
Bayesian optimization for parallel workers [9]).

ask(n) returns n *distinct* points even before any results return: each
accepted point is added as a pseudo-observation at the current posterior
mean ("constant liar"), so simultaneous workers spread out instead of
piling onto the same optimum — the core requirement for the paper's
"multiple model configurations simultaneously" workflow.

Hot-path contract: ask(n) performs **at most one** hyperparameter
fit per batch — warm-started from the previous optimum — then selects the
whole batch with ``gp.select_batch`` (one q-EI scan with rank-1
constant-liar updates, O(n²) per lie instead of a full refit per point).
Pending lies are keyed by a ``__lie`` token carried in the assignment, so
near-identical suggestions (speculative twins, densified local candidates)
always retire the *right* lie.

Refit scheduling: ``warm_fit_steps``/``refit_every`` are *base*
values of an adaptive schedule rather than fixed constants.  Past
``ADAPT_N`` observations the warm-fit step budget shrinks (the warm start
is near-converged; each Adam step is O(n³)) and the refit period grows
with the history and — in service-pipeline mode — with the measured
fit-latency : observation-arrival ratio, so hyperfits can never consume
more than ~``FIT_DUTY`` of the optimizer's wall-time.  The live schedule
is observable via ``refit_schedule()`` (surfaced in ``StatusResponse``
pump stats).  ``ask(n, speculative=True)`` additionally lets the service
refill its prefetch queue from the sparse subset-of-data posterior
(``gp.sparse_posterior``) when the exact path is saturated.
"""
from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.space import Assignment, Space, strip_internal as _clean
from repro_torch.core.suggest import gp
from repro_torch.core.suggest.base import Observation, Optimizer, register
from repro_torch.device import resolve

LIE_KEY = "__lie"

#: History size below which the base ``warm_fit_steps``/``refit_every``
#: apply verbatim (small histories: cheap, frequent fits; the adaptive
#: schedule only kicks in past this).  Matches ``gp.SPARSE_MAX`` — the
#: same threshold past which the sparse speculative posterior differs
#: from the exact one.
ADAPT_N = gp.SPARSE_MAX
#: Floor for the adaptive warm-fit step budget.
MIN_WARM_STEPS = 8
#: Ceiling for the adaptive refit period (observations between hyperfits).
MAX_REFIT_EVERY = 64
#: Largest fraction of wall-time (measured as fit-latency over observation
#: inter-arrival time) the deferred hyperfits may consume in pipeline mode.
FIT_DUTY = 0.25

#: Bounds of the live inducing-set budget ladder: the service
#: feeds its sparse-vs-exact regret counters back through ``tune_sparse``,
#: halving the subset while sparse quality tracks exact (cheaper refills)
#: and doubling it when it drifts.  The *eligibility* threshold stays the
#: class constant ``gp.SPARSE_MAX`` — tuning changes how much the sparse
#: posterior costs, never when it may serve.
SPARSE_MIN = 16
SPARSE_LADDER_MAX = 2 * gp.SPARSE_MAX
#: Relative slack on the sparse mean regret before the subset grows.
SPARSE_TOL = 0.25
#: Fresh finished-trial observations (per serving class) required between
#: ladder moves — one burst can't walk the budget to a rail.
SPARSE_TUNE_OBS = 8


class FitSpec:
    """Batchable deferred-fit descriptor — what
    ``Optimizer.fit_spec`` snapshots under the optimizer lock for the
    shared FitExecutor.  Specs sharing ``group_key`` may be co-batched
    into one lane-batched dispatch — since the masked variable-step fit loop
    the key is ``(runner, bucket)`` only: lanes on different
    rungs of the adaptive warm-step ladder merge into one ``max(steps)``
    dispatch with per-lane freeze masks.  ``install(params, fit_seconds)``
    is called back under the optimizer lock, preserving the two-phase
    no-mutation contract (compute never touches live state).  ``device``
    is where the fit runs; it joins the group key, so lanes on different
    devices never stack."""
    kind = "fit"
    __slots__ = ("bucket", "steps", "x", "y", "params0", "install",
                 "runner", "device")

    def __init__(self, bucket, steps, x, y, params0, install, runner,
                 device=None):
        self.bucket = int(bucket)
        self.steps = int(steps)
        self.x = x
        self.y = y
        self.params0 = params0
        self.install = install
        self.runner = runner
        self.device = device

    @property
    def group_key(self):
        return (self.runner, self.bucket, self.device)


def run_fit_lanes(specs: Sequence[FitSpec]):
    """FitExecutor lane runner: fit every spec (all sharing one shape
    bucket) in one ``gp.batched_fit`` dispatch — or the ordinary
    ``fit_gp`` path for a single lane, as in the reference: a lone refit
    autodiffs the plain torch ``neg_mll``, and only co-batched refits
    reach the ``gp_nll`` kernel.  Mixed
    per-lane step counts are fine: the batched fit runs a masked
    ``max(steps)`` loop that freezes each lane at its own budget.
    Returns (list of fitted GPParams, total wall seconds)."""
    t0 = time.perf_counter()
    if len(specs) == 1:
        s = specs[0]
        post = gp.fit_gp(s.x, s.y, steps=s.steps, params0=s.params0,
                         bucket=s.bucket, device=s.device)
        out = [post.params]
    else:
        out = gp.batched_fit([(s.x, s.y, s.params0) for s in specs],
                             steps=[s.steps for s in specs],
                             bucket=specs[0].bucket,
                             device=specs[0].device)
    return out, time.perf_counter() - t0


class AskSpec:
    """Batchable deferred-*ask* descriptor — what
    ``BayesOpt.ask_spec`` snapshots under the optimizer lock so the
    shared FitExecutor can gather queue-refill asks from several
    experiments into ONE lane-batched q-EI dispatch
    (``gp.batched_select``).  Specs sharing ``group_key`` — same runner,
    posterior bucket, scan pad and candidate-pool shape — stack on a lane
    axis.  ``install(result, dt)`` — result the lane's ``(picks, posterior)`` pair — is called back
    under the optimizer lock; it mints the suggestions' assignments
    (registering their constant-liar tokens) and either adopts the
    lie-folded posterior (when the optimizer's posterior is unchanged
    since the snapshot) or just marks a recondition — batched refills
    are speculative-queue-only, so the staleness bound contains any
    mid-flight drift exactly as it does for sparse refills."""
    kind = "ask"
    __slots__ = ("bucket", "k", "k_pad", "post", "cand", "best",
                 "install", "runner", "sparse")

    def __init__(self, bucket, k, post, cand, best, install, runner,
                 sparse=False, k_pad=None):
        self.bucket = int(bucket)
        self.k = int(k)
        self.k_pad = int(gp.SELECT_PAD if k_pad is None else k_pad)
        self.post = post
        self.cand = cand
        self.best = best
        self.install = install
        self.runner = runner
        self.sparse = bool(sparse)

    @property
    def group_key(self):
        return (self.runner, self.bucket, self.k_pad,
                tuple(self.cand.shape))


def run_ask_lanes(specs: Sequence[AskSpec]):
    """FitExecutor lane runner for batched refill asks: run every
    spec's q-EI batch selection in one ``gp.batched_select`` dispatch.
    Returns (list of per-lane (picks, posterior) pairs, wall seconds) —
    the executor feeds each pair to its lane's ``install``."""
    t0 = time.perf_counter()
    out = gp.batched_select([(s.post, s.cand, s.best, s.k) for s in specs],
                            k_pad=specs[0].k_pad)
    return out, time.perf_counter() - t0


@register("gp")
@register("bayesopt")
class BayesOpt(Optimizer):
    expensive_ask = True        # service runs the prefetch pump for us
    speculative_ask = True      # honors ask(n, speculative=True)
    batchable_fits = True       # fit_spec() descriptors may co-batch
    batchable_asks = True       # ask_spec() descriptors may co-batch

    def __init__(self, space: Space, seed: int = 0, n_init: int = 8,
                 candidates: int = 1024, fit_steps: int = 150,
                 warm_fit_steps: int = 40, refit_every: int = 4,
                 adaptive: bool = True, device=None):
        super().__init__(space, seed)
        # where the GP tensors live; the CUDA linear algebra is loaded
        # here, before this optimizer's pump or fits run on other threads
        self.device = resolve(device, linalg=True)
        self.n_init = n_init
        self.n_candidates = candidates
        self.fit_steps = fit_steps
        self.warm_fit_steps = warm_fit_steps
        self.refit_every = refit_every
        self.adaptive = adaptive
        self._post = None
        self._params = None                    # warm-start hyperparameters
        self._since_fit = 0
        self._needs_fit = True
        self._needs_recondition = False
        self._n_in_post = 0                    # real + lie rows in posterior
        self._pending: Dict[str, np.ndarray] = {}   # lie key -> unit coords
        # per-instance nonce: a stale token from a pre-restart in-flight
        # trial must never collide with this incarnation's keys
        self._lie_nonce = uuid.uuid4().hex[:8]
        self._lie_seq = 0
        self._xs: List[np.ndarray] = []        # unit coords of successes
        self._ys: List[float] = []
        self._prewarmed = 0                    # largest bucket prewarmed
        # Service pipeline mode (set by the prefetch pump): ask() never
        # runs a hyperparameter fit once warm-started — new observations
        # are folded by an exact recondition at the current
        # hyperparameters (one O(b³) Cholesky), and the owed refit runs
        # later in maintain() on the pump thread.  Default False: the
        # raw ask/tell contract (one warm fit per ask batch) is unchanged.
        self.defer_fits = False
        # --- adaptive refit schedule + sparse speculation ---
        self._fit_ema = None            # EMA of hyperfit wall seconds
        self._arrival_ema = None        # EMA of observation inter-arrival s
        self._last_obs_t = None
        self._fits = 0                  # hyperfits run (cold + warm)
        self._sparse_post = None        # cached subset-of-data posterior
        self._sparse_rows = 0           # rows folded into _sparse_post
        self._sparse_m = 0              # subset size of the cached sparse
        self._sparse_asks = 0           # speculative points served sparse
        self._sparse_max = gp.SPARSE_MAX  # live inducing-set budget
        self._sparse_tune_mark = None   # quality counters at last tune

    # ------------------------------------------------- refit schedule
    def warm_steps(self) -> int:
        """Adaptive warm-fit step budget: the base ``warm_fit_steps`` up
        to ``ADAPT_N`` observations, then shrinking ~1/n (each Adam step
        costs O(n³) and the warm start is near-converged), floored at
        ``MIN_WARM_STEPS``."""
        return self._warm_steps_at(len(self._ys))

    def _warm_steps_at(self, n: int) -> int:
        """The schedule as a pure function of history size.  A halving
        ladder, not a smooth 1/n, kept from the reference so both
        packages fit with the same step counts at the same history
        sizes."""
        s = self.warm_fit_steps
        if not self.adaptive:
            return s
        h = ADAPT_N
        while n > h and s // 2 >= MIN_WARM_STEPS:
            s //= 2
            h *= 2
        return s

    def refit_period(self) -> int:
        """Adaptive refit period: the base ``refit_every`` up to
        ``ADAPT_N`` observations, then growing with the history
        (hyperparameters move slowly once the posterior is data-rich) and
        — in ``defer_fits`` pipeline mode — with the measured
        fit-latency : arrival-rate ratio so deferred hyperfits stay under
        a ``FIT_DUTY`` share of wall-time under sustained load."""
        n = len(self._ys)
        if not self.adaptive or n <= ADAPT_N:
            return self.refit_every
        period = max(self.refit_every, n // 16)
        if (self.defer_fits and self._fit_ema is not None
                and self._arrival_ema is not None and self._arrival_ema > 0):
            period = max(period, int(np.ceil(
                self._fit_ema / (self._arrival_ema * FIT_DUTY))))
        return min(period, MAX_REFIT_EVERY)

    def refit_schedule(self) -> Dict[str, object]:
        """Live schedule readout (StatusResponse pump stats)."""
        ms = (lambda s: None if s is None else round(s * 1e3, 3))
        return {"n": len(self._ys), "warm_steps": self.warm_steps(),
                "refit_every": self.refit_period(),
                "since_fit": self._since_fit, "fits": self._fits,
                "fit_ms": ms(self._fit_ema),
                "arrival_ms": ms(self._arrival_ema),
                "sparse_asks": self._sparse_asks,
                "sparse_m": self._sparse_m,
                "sparse_max": self._sparse_max}

    # ------------------------------------------------------------------
    def prewarm(self, max_history: int, batch: int = 8) -> int:
        """Prewarm each power-of-two bucket up to
        ``bucket_size(max_history)`` (``gp.prewarm_bucket``), so the
        one-time work — the CUDA kernels' build and load, PyTorch's CUDA
        linear algebra, a first allocation at each bucket's size — lands
        off the request path.  Touches no optimizer state — safe to call
        from a background thread while ``ask``/``tell`` run elsewhere."""
        target = gp.bucket_size(max(1, int(max_history)))
        warmed = 0
        b = gp.MIN_BUCKET
        while b <= target:
            if b > self._prewarmed:
                gp.prewarm_bucket(len(self.space), b, fit_lanes=(1,),
                                  device=self.device)
                warmed += 1
            b *= 2
        self._prewarmed = max(self._prewarmed, target)
        return warmed
    def _new_lie(self, u: np.ndarray) -> str:
        self._lie_seq += 1
        key = f"lie-{self._lie_nonce}-{self._lie_seq:05d}"
        self._pending[key] = np.asarray(u, float)
        return key

    def _free_slots(self) -> int:
        if self._post is None:
            return 0
        return self._post.capacity - self._n_in_post

    def _refit(self, extra: int = 0) -> None:
        """One (warm-started) hyperparameter fit sized so the bucket can
        absorb all pending lies plus ``extra`` upcoming picks, then rank-1
        re-folds of the pending lies.  The only O(steps·n³) call on the
        ask path."""
        if len(self._ys) < max(2, len(self.space)):
            self._post = None
            return
        x = np.asarray(self._xs)
        y = np.asarray(self._ys)
        bucket = gp.bucket_size(len(x) + len(self._pending) + extra)
        steps = (self.warm_steps() if self._params is not None
                 else self.fit_steps)
        t0 = time.perf_counter()
        post = gp.fit_gp(x, y, steps=steps, params0=self._params,
                         bucket=bucket, device=self.device)
        dt = time.perf_counter() - t0
        self._fit_ema = dt if self._fit_ema is None \
            else 0.7 * self._fit_ema + 0.3 * dt
        self._fits += 1
        self._params = post.params
        for u in self._pending.values():
            post = gp.append_lie(post, np.asarray(u, np.float32))
        self._post = post
        self._sparse_post = None        # new hyperparameters
        self._n_in_post = len(x) + len(self._pending)
        self._needs_fit = False
        self._needs_recondition = False
        self._since_fit = 0

    def _recondition(self, extra: int = 0) -> None:
        """Exact posterior rebuild at the *current* hyperparameters (one
        O(b³) Cholesky, no Adam) — drops stale constant-liar rows and
        folds the pending set back in.  The cheap path between the
        every-``refit_every``-observations hyperparameter fits."""
        if self._params is None:
            self._refit(extra=extra)
            return
        x = np.asarray(self._xs)
        y = np.asarray(self._ys)
        bucket = gp.bucket_size(len(x) + len(self._pending) + extra)
        post = gp.make_posterior(self._params, x, y, bucket=bucket,
                                 device=self.device)
        for u in self._pending.values():
            post = gp.append_lie(post, np.asarray(u, np.float32))
        self._post = post
        self._n_in_post = len(x) + len(self._pending)
        self._needs_recondition = False

    def maintenance_due(self) -> bool:
        """True when a deferred hyperparameter refit is owed — what the
        service pump checks before queueing a job on the shared fit
        executor."""
        return self._needs_fit and len(self._ys) >= max(2, len(self.space))

    def maintain(self) -> bool:
        """Run the owed hyperparameter refit, if any (``defer_fits``
        mode), inline and under the caller's lock.  The service's shared
        fit executor prefers ``fit_job`` (lock-free compute)."""
        if self.maintenance_due():
            self._refit()
            return True
        return False

    def fit_spec(self) -> Optional[FitSpec]:
        """Snapshot the owed hyperparameter fit as a batchable
        ``FitSpec`` — arrays copied under the caller's lock,
        so the executor may run the fit (alone or co-batched with other
        experiments sharing the (bucket, steps) group) with no lock
        held.  ``spec.install(params, dt)`` must be called back under
        the optimizer lock: it only adopts the new hyperparameters and
        marks a recondition; the next ``ask`` folds them together with
        any observations that arrived mid-fit, so a lane whose
        experiment saw a mid-fit burst just re-arms."""
        if not self.maintenance_due():
            return None
        x = np.asarray(self._xs)
        y = np.asarray(self._ys)
        params0 = self._params
        steps = self.warm_steps() if params0 is not None else self.fit_steps
        bucket = gp.bucket_size(len(x))
        n_snap = len(y)

        def install(params, dt):
            self._fit_ema = dt if self._fit_ema is None \
                else 0.7 * self._fit_ema + 0.3 * dt
            self._fits += 1
            self._params = params
            self._sparse_post = None
            # observations that landed mid-fit stay counted as debt —
            # and if they already exceed the period (a burst arrived
            # during the fit), the next fit is owed immediately, else
            # the MAX_REFIT_EVERY staleness bound would silently slip
            self._since_fit = max(0, len(self._ys) - n_snap)
            self._needs_fit = self._since_fit >= self.refit_period()
            self._needs_recondition = True

        return FitSpec(bucket=bucket, steps=steps, x=x, y=y,
                       params0=params0, install=install,
                       runner=run_fit_lanes, device=self.device)

    def fit_job(self):
        """Snapshot the owed hyperparameter fit as a lock-free closure
       : the caller invokes the returned ``run()`` WITHOUT
        holding the optimizer lock — it is pure torch compute over copied
        arrays — and then applies the ``install()`` it returns under the
        lock.  Single-lane view of ``fit_spec`` (same snapshot, same
        install semantics)."""
        spec = self.fit_spec()
        if spec is None:
            return None

        def run():
            out, dt = run_fit_lanes([spec])

            def install():
                spec.install(out[0], dt)
            return install
        return run

    # ----------------------------------------------------- batchable ask
    def ask_spec_ready(self) -> bool:
        """Whether ``ask_spec`` would yield a batchable refill right now
        — the service pump checks this (under the optimizer lock) before
        routing a queue refill through the shared executor instead of an
        inline ``ask``.  Only the random init phase is excluded: random
        suggestions are cheap and carry no posterior to batch."""
        return len(self._ys) >= max(self.n_init, 2, len(self.space))

    def ask_spec(self, n: int = 1,
                 speculative: bool = False) -> Optional["AskSpec"]:
        """Snapshot a queue-refill ask as a batchable ``AskSpec``
       .  Performs exactly the posterior preparation ``ask``
        would — recondition / sparse rebuild under the caller-held
        optimizer lock — but *defers the q-EI selection scan* to the
        executor, which may co-batch it with other experiments' refills
        into one ``gp.batched_select`` dispatch.  ``spec.install`` must
        be called back under the optimizer lock; it returns the minted
        assignments (lie tokens registered, exactly as ``ask`` would
        have produced).  Returns None outside the model phase or when
        ``n`` exceeds the fixed ``gp.SELECT_PAD`` scan pad."""
        n = int(n)
        if n <= 0 or n > gp.SELECT_PAD or not self.ask_spec_ready():
            return None
        sparse = bool(speculative and self.sparse_eligible())
        if sparse:
            if (self._sparse_post is None
                    or self._sparse_post.capacity - self._sparse_rows < n):
                self._sparse_recondition(extra=n)
            post = self._sparse_post
        else:
            if self._post is None or (self._needs_fit
                                      and not (self.defer_fits
                                               and self._params is not None)):
                self._refit(extra=n)
            elif (self._needs_fit or self._needs_recondition
                    or self._free_slots() < n):
                self._recondition(extra=n)
            post = self._post
            if post is None:
                return None
        cand = self._candidates()
        best = float(max(self._ys))

        def install(result, dt):
            picks, lane_post = result
            out = []
            for j in np.asarray(picks):
                u = np.asarray(cand[int(j)], float)
                a = self.space.from_unit(u)
                a[LIE_KEY] = self._new_lie(u)
                out.append(a)
            if sparse:
                if self._sparse_post is post:
                    # nothing moved mid-dispatch: adopt the lie-folded
                    # sparse posterior — the exact fast path
                    self._sparse_post = lane_post
                    self._sparse_rows += n
                else:
                    self._sparse_post = None
                self._sparse_asks += n
                self._needs_recondition = True
            else:
                if self._post is post and not self._needs_recondition:
                    self._post = lane_post
                    self._n_in_post += n
                else:
                    # the posterior moved while the dispatch was in
                    # flight (observation fold / forget): the minted
                    # lies are registered but not folded — the next
                    # exact ask reconditions with the full pending set.
                    # Safe because batched refills only feed the
                    # staleness-bounded speculative queue.
                    self._needs_recondition = True
                self._sparse_post = None
            return out

        return AskSpec(bucket=post.capacity, k=n, post=post, cand=cand,
                       best=best, install=install, runner=run_ask_lanes,
                       sparse=sparse)

    def ask(self, n: int = 1, speculative: bool = False) -> List[Assignment]:
        n = int(n)
        if n <= 0:
            return []
        if len(self._ys) < max(self.n_init, 2, len(self.space)):
            return self._ask_random(n)
        if speculative and self.sparse_eligible():
            return self._ask_sparse(n)
        if self._post is None or (self._needs_fit
                                  and not (self.defer_fits
                                           and self._params is not None)):
            self._refit(extra=n)
        elif (self._needs_fit or self._needs_recondition
                or self._free_slots() < n):
            # deferred-fit mode: fold the new observations exactly at the
            # current hyperparameters; maintain() pays the fit later
            self._recondition(extra=n)
        if self._post is None:
            return self._ask_random(n)
        cand = self._candidates()
        best_y = np.float32(max(self._ys))
        picks, post = gp.select_batch(self._post, cand, best_y, n)
        self._post = post
        self._n_in_post += n
        # the new exact-path lies are not in the cached sparse posterior:
        # a later speculative refill must rebuild it or it could re-pick
        # these very points
        self._sparse_post = None
        out = []
        for j in np.asarray(picks):
            u = np.asarray(cand[int(j)], float)
            a = self.space.from_unit(u)
            a[LIE_KEY] = self._new_lie(u)
            out.append(a)
        return out

    # ------------------------------------------- sparse speculative ask
    def sparse_eligible(self) -> bool:
        """Whether ``ask(n, speculative=True)`` would actually take the
        sparse path right now — the service checks this so its
        ``sparse_prefilled``/``sparse_served`` counters only ever count
        genuinely sparse suggestions.  The sparse path only exists to
        break refit-bound saturation: it needs already-fit
        hyperparameters, a history large enough that the subset actually
        differs in cost (past ``gp.SPARSE_MAX`` the exact Cholesky
        outgrows the sparse one), and pipeline mode (the exact posterior
        still serves synchronous asks and misses)."""
        return (self.defer_fits and self._params is not None
                and len(self._ys) > gp.SPARSE_MAX)

    def tune_sparse(self, quality: Dict[str, float]) -> Optional[int]:
        """Feed the service's sparse-vs-exact quality counters (cumulative
        finished-trial counts + summed instantaneous regret, maintained at
        observe time) back into the live inducing-set budget.  Compares
        the *windowed* mean regret since the last ladder move: while sparse-served suggestions regret no
        more than ``1+SPARSE_TOL`` times the exact-served ones (plus a
        small absolute slack at the objective's scale), the subset halves
        — cheaper refills at no measured quality cost; when it drifts
        past the tolerance, it doubles back.  Moves one ladder step per
        ``SPARSE_TUNE_OBS`` fresh observations of each class, clamped to
        [SPARSE_MIN, SPARSE_LADDER_MAX].  Returns the new budget when it
        changed, else None.  Call under the optimizer lock."""
        s_n = int(quality.get("sparse_obs", 0) or 0)
        s_r = float(quality.get("sparse_regret", 0.0) or 0.0)
        e_n = int(quality.get("exact_obs", 0) or 0)
        e_r = float(quality.get("exact_regret", 0.0) or 0.0)
        if self._sparse_tune_mark is None:
            self._sparse_tune_mark = (s_n, s_r, e_n, e_r)
            return None
        m_sn, m_sr, m_en, m_er = self._sparse_tune_mark
        d_sn, d_en = s_n - m_sn, e_n - m_en
        if d_sn < SPARSE_TUNE_OBS or d_en < SPARSE_TUNE_OBS:
            return None
        self._sparse_tune_mark = (s_n, s_r, e_n, e_r)
        mean_s = (s_r - m_sr) / d_sn
        mean_e = (e_r - m_er) / d_en
        # absolute slack: regret means near zero (a converged experiment)
        # must not read as drift from float dust — scale by the objective
        slack = 0.05 * (float(np.std(self._ys)) if len(self._ys) > 1
                        else 1.0)
        cur = self._sparse_max
        if mean_s <= mean_e * (1.0 + SPARSE_TOL) + slack:
            new = max(SPARSE_MIN, cur // 2)
        else:
            new = min(SPARSE_LADDER_MAX, cur * 2)
        if new == cur:
            return None
        self._sparse_max = new
        self._sparse_post = None        # rebuild at the new budget
        return new

    def _sparse_recondition(self, extra: int) -> None:
        """(Re)build the cached subset-of-data posterior at the current
        hyperparameters and fold the pending lies in — O(m³) with
        m <= the live ``_sparse_max`` budget, independent of history
        size."""
        post, idx = gp.sparse_posterior(self._params, np.asarray(self._xs),
                                        np.asarray(self._ys),
                                        m=self._sparse_max,
                                        extra=len(self._pending) + extra,
                                        device=self.device)
        for u in self._pending.values():
            post = gp.append_lie(post, np.asarray(u, np.float32))
        self._sparse_post = post
        self._sparse_m = len(idx)
        self._sparse_rows = len(idx) + len(self._pending)

    def _ask_sparse(self, n: int) -> List[Assignment]:
        """Select a speculative batch from the sparse posterior (one
        bounded Cholesky + the same q-EI scan), leaving the exact
        posterior untouched.  Lies are registered exactly like exact-path
        lies, so retirement/recondition see no difference."""
        if (self._sparse_post is None
                or self._sparse_post.capacity - self._sparse_rows < n):
            self._sparse_recondition(extra=n)
        cand = self._candidates()
        best_y = np.float32(max(self._ys))
        picks, post = gp.select_batch(self._sparse_post, cand, best_y, n)
        self._sparse_post = post
        self._sparse_rows += n
        self._sparse_asks += n
        # the new lies live only in the sparse posterior: the next exact
        # ask must fold the full pending set back in before selecting
        self._needs_recondition = True
        out = []
        for j in np.asarray(picks):
            u = np.asarray(cand[int(j)], float)
            a = self.space.from_unit(u)
            a[LIE_KEY] = self._new_lie(u)
            out.append(a)
        return out

    def _ask_random(self, n: int) -> List[Assignment]:
        out = []
        for a in self.space.sample(self.rng, n):
            a[LIE_KEY] = self._new_lie(self.space.to_unit(_clean(a)))
            out.append(a)
        self._sparse_post = None    # lies the sparse cache hasn't seen
        return out

    def _candidates(self) -> np.ndarray:
        d = len(self.space)
        cand = self.rng.uniform(size=(self.n_candidates, d))
        # densify around the incumbent (local exploitation pool); the
        # total is a fixed shape, so every pool of an experiment stacks
        inc = self._xs[int(np.argmax(self._ys))]
        local = np.clip(inc[None] + self.rng.normal(
            0, 0.08, size=(self.n_candidates // 4, d)), 0, 1)
        return np.concatenate([cand, local], axis=0).astype(np.float32)

    def _retire_lie(self, o: Observation) -> bool:
        """Remove the observation's pending lie; True if one was retired."""
        key = None
        if isinstance(o.assignment, dict):
            key = o.assignment.get(LIE_KEY)
        if key is None and o.metadata:
            key = o.metadata.get(LIE_KEY)
        if key is not None:
            return self._pending.pop(key, None) is not None
        # legacy observations without a lie token: nearest-match fallback
        u = self.space.to_unit(_clean(o.assignment))
        for k, pend in self._pending.items():
            if np.allclose(pend, u, atol=1e-6):
                del self._pending[k]
                return True
        return False

    def forget(self, assignment: Assignment) -> None:
        """Retire the lie of a suggestion that will never be observed
        (released / stopped), so it stops suppressing EI at that point."""
        if self._retire_lie(Observation(assignment, None)):
            self._sparse_post = None
            if self._post is not None:
                self._needs_recondition = True

    def _update(self, observations: Sequence[Observation]) -> None:
        if observations:
            # arrival-rate EMA for the latency-aware refit period; batch
            # replays (restore) collapse to one arrival sample
            now = time.monotonic()
            if self._last_obs_t is not None:
                dt = max(now - self._last_obs_t, 1e-6) / len(observations)
                self._arrival_ema = dt if self._arrival_ema is None \
                    else 0.7 * self._arrival_ema + 0.3 * dt
            self._last_obs_t = now
            self._sparse_post = None    # data changed
        for o in observations:
            retired = self._retire_lie(o)
            if retired and self._post is not None:
                # the retired lie's row is folded into the posterior; a
                # rank-1 *removal* isn't worth the downdate, so rebuild
                # (cheaply, at current hyperparameters) on the next ask
                # instead of conditioning on both the stale lie and the
                # real value for the same point
                self._needs_recondition = True
            if (not o.failed and o.value is not None
                    and np.isfinite(o.value)):
                u = self.space.to_unit(_clean(o.assignment))
                self._xs.append(u)
                self._ys.append(float(o.value))
                if (not retired and self._post is not None
                        and not self._needs_recondition and not self._needs_fit
                        and self._free_slots() >= 1):
                    # lie-free observation (restore replay / external
                    # tell): exact rank-1 fold, no rebuild needed
                    self._post = gp.append_point(
                        self._post, np.asarray(u, np.float32),
                        np.float32(o.value))
                    self._n_in_post += 1
                elif not retired:
                    self._needs_recondition = True
        self._since_fit += len(observations)
        if self._since_fit >= self.refit_period():
            self._needs_fit = True
