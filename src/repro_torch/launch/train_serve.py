"""Live train->serve loop on one discrete-event clock (port of
``repro.launch.train_serve``): the elastic training fleet keeps improving
the model (``core/event_loop.py``) while the serving engine answers
prediction requests for it (``repro_torch.serving``), and every
``publish_every`` iterations the master's post-step params are
HOT-SWAPPED into the engine while requests are in flight.

The paper's promise is a single live system: "prediction to the public
at large" against the very model the swarm is training. The training
loop's clock and the serving session's clock are the same axis; a
publish at training time ``t`` reaches clients admitted after ``t``,
while requests already in flight finish under the version they pinned
at admission. The printed version histogram reads as "how stale was the
model each client saw". Serving time is the ``ServeCostModel``'s
simulated clock, not the card's.

  python -m repro_torch.launch.train_serve --iterations 12 --requests 64
  python -m repro_torch.launch.train_serve --snapshot-out ts.npz
  python -m repro_torch.launch.train_serve --from-snapshot ts.npz
  PYTHONPATH=src python -m repro_torch.launch.train_serve --device cpu

``--from-snapshot`` resumes training AND seeds the engine from the same
TrainState. ``--arch`` trains and serves that config reduced, or at full
width with ``--full-width`` (pass ``--lr 0.003`` there: the default 0.1
diverges ``mlitb-lm-100m``).

``build_training`` assembles the paper's event loop around ``cfg``'s LM:
a seeded heterogeneous fleet (``_fleet_profiles``) on the discrete-event
simulator, every worker computing real next-token gradients on the
problem's device, the fused top-k compressed reduce with AdaGrad, and
deadline partial participation.

``--speculative K`` serves with a K-token draft: the served arch at
init, so acceptance is low, while the output stays the exact greedy
stream.

Not ported yet: the two-tier hierarchy (``TrainingConfig(hierarchy=)``,
ROADMAP A5).
"""
from __future__ import annotations

import argparse
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels.runtime import DeviceLike

_UNSET: Any = object()

# tiny default LM: big enough to have real train/serve dynamics, small
# enough that the CPU tests run the whole loop in seconds
TINY_SERVE_LM = dict(
    name="train-serve-tiny", arch_type="dense", n_layers=2, d_model=32,
    n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16,
    param_dtype="float32", activ_dtype="float32", tie_embeddings=True)


def tiny_cfg():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**TINY_SERVE_LM)


def _fleet_profiles(churny: bool):
    from repro_torch.core.simulation import DeviceProfile
    profiles = [DeviceProfile("ws0", 300.0, 0.010, 0.20),
                DeviceProfile("ws1", 300.0, 0.012, 0.20),
                DeviceProfile("lap", 150.0, 0.030, 0.40)]
    if churny:
        profiles.append(DeviceProfile("strag", 200.0, 0.050, 0.40,
                                      straggle_p=0.3, straggle_factor=8.0))
    return profiles


def build_training(cfg, *, training=None, seed: int = 0,
                   n_data: int = 512, seq_len: int = 16,
                   lr: float = 0.1, frac: float = 0.1,
                   churny: bool = True,
                   fault_profiles: Optional[Dict[str, Any]] = None,
                   optimizer=None, device: DeviceLike = "cuda",
                   init_params=None,
                   T: Any = _UNSET, publish_every: Any = _UNSET,
                   publish_fn: Any = _UNSET, guardrails: Any = _UNSET):
    """An elastic training stack over ``cfg``'s LM on ``device``: fused
    top-k compressed reduce, deadline partial participation, and (when
    ``churny``) a heterogeneous fleet with a probabilistic straggler.
    Returns ``(MasterEventLoop, cluster, params)``.

    ``training=TrainingConfig(...)`` is the construction surface; the
    historical flat kwargs (T/publish_every/publish_fn/guardrails) still
    work for one deprecation cycle, and mixing both forms raises. With no
    explicit deadline the fleet gets the churny default (quantile 0.5
    when ``churny``, stall-on-slowest otherwise). ``init_params`` (a
    parameter tree on ``device``) replaces the seeded initialisation;
    ``optimizer`` replaces AdaGrad(lr) (plain SGD lets a garbage
    gradient actually diverge the params)."""
    from repro_torch.core import (AdaptiveScheduler, GradientCompressor,
                                  JoinEvent, MasterEventLoop, MasterReducer,
                                  TrainingConfig, UploadDataEvent)
    from repro_torch.core.simulation import SimulatedCluster, make_lm_problem
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adagrad

    dev = resolve_device(device)
    flat = {k: v for k, v in [
        ("T", T), ("publish_every", publish_every),
        ("publish_fn", publish_fn), ("guardrails", guardrails),
    ] if v is not _UNSET}
    if training is not None and flat:
        raise ValueError(
            "pass training=TrainingConfig(...) OR the flat kwargs, "
            f"not both (got flat {sorted(flat)})")
    if training is None:
        if flat:
            warnings.warn(
                f"build_training flat kwargs ({sorted(flat)}) are "
                "deprecated; pass training=TrainingConfig(...)",
                DeprecationWarning, stacklevel=2)
        flat.setdefault("T", 0.5)
        training = TrainingConfig.from_flat(
            deadline_quantile=0.5 if churny else None, **flat)

    (X, y), grad_fn = make_lm_problem(cfg, n_data=n_data, seq_len=seq_len,
                                      seed=seed, device=dev)
    params = (tf.init_params(cfg, seed=seed, device=dev)
              if init_params is None else init_params)
    reducer = MasterReducer(params, optimizer or adagrad(lr=lr),
                            compressor=GradientCompressor("topk", frac=frac),
                            fused=True)
    cluster = SimulatedCluster(grad_fn=grad_fn, data=(X, y), mode="real",
                               seed=seed, device=dev)
    loop = MasterEventLoop(
        reducer=reducer, cluster=cluster,
        scheduler=AdaptiveScheduler(T=training.T, prior_power=300.0,
                                    min_budget=0.05),
        training=training)
    loop.submit(UploadDataEvent(range(n_data)))
    for i, prof in enumerate(_fleet_profiles(churny)):
        cluster.add_worker(f"w{i}", prof)
        loop.submit(JoinEvent(f"w{i}", capacity=n_data))
    for w, fp in (fault_profiles or {}).items():
        cluster.set_faults(w, fp)
    return loop, cluster, params


def run_train_serve(cfg, requests: Sequence[Any], *,
                    iterations: int = 12, publish_every: int = 2,
                    T: float = 0.5, seed: int = 0,
                    max_batch: int = 4, max_seq: int = 64,
                    prompt_cap: Optional[int] = 16,
                    temperature: float = 0.0, top_k: int = 0,
                    churny: bool = True,
                    cost=None, lr: float = 0.1,
                    engine_params=None,
                    start_version: int = 0,
                    resume_state=None,
                    guardrails=None, canary=None,
                    fault_profiles: Optional[Dict[str, Any]] = None,
                    publish_filter=None, optimizer=None,
                    max_queue: Optional[int] = None,
                    shed_policy: str = "reject",
                    admission_deadline: Optional[float] = None,
                    page_size: Optional[int] = None,
                    n_pages: Optional[int] = None,
                    prefix_reuse: bool = True,
                    decode_kernel: str = "flash",
                    speculative=None,
                    init_params=None,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Drive ``iterations`` of elastic training and the serving engine on
    ONE discrete-event clock, hot-swapping published params in flight,
    on ``device`` (default ``"cuda"``; raises without CUDA unless given
    ``"cpu"``).

    ``guardrails`` arms the training watchdog, ``fault_profiles``
    ({worker: FaultProfile}) injects seeded faults, ``canary`` screens
    every publish (a refused candidate is recorded in ``refused`` and
    never reaches the engine), and ``max_queue``/``shed_policy``/
    ``admission_deadline`` bound the serving queue. ``publish_filter``
    (params, version) -> params lets chaos harnesses corrupt candidates
    between the training loop and the canary. ``init_params`` (a param
    tree on ``device``) replaces the seeded initialisation, as in
    ``build_training``. ``decode_kernel`` is ``"flash"`` (the CUDA
    flash-decode kernel on the card) or ``"plain"`` (the JAX package's
    ``"xla"``).

    Every published tree is the reducer's params at that step: views of
    a flat buffer the reducer never writes in place, so the engine
    serves a snapshot without copying it.

    Returns a dict with the training ``logs``, serving ``stats``, the
    ``engine``/``loop``/``cluster`` objects, ``published`` [(clock,
    version), ...], ``refused`` [(clock, version), ...] and ``versions``
    {version: params} — every tree the engine served under, so callers
    can replay any completion solo under its pinned version."""
    from repro_torch.core.config import (DeadlineConfig, PublishConfig,
                                         TrainingConfig)
    from repro_torch.core.simulation import ServeCostModel
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     SimulatedServeSession)

    cost = cost or ServeCostModel()
    versions: Dict[int, Any] = {}
    published: List[Tuple[float, int]] = []
    refused: List[Tuple[float, int]] = []
    session_box: List[SimulatedServeSession] = []

    def publish(params, version, clock):
        if publish_filter is not None:
            params = publish_filter(params, version)
        if canary is not None and not canary.check(params, version):
            refused.append((clock, version))
            return
        session_box[0].push_swap(clock, params, version)
        versions[version] = params
        published.append((clock, version))

    loop, cluster, _ = build_training(
        cfg, training=TrainingConfig(
            T=T,
            deadline=DeadlineConfig(quantile=0.5 if churny else None),
            publish=PublishConfig(
                every=publish_every,
                fn=publish if publish_every > 0 else None),
            guardrails=guardrails),
        seed=seed, churny=churny, lr=lr, fault_profiles=fault_profiles,
        optimizer=optimizer, device=device, init_params=init_params)
    if resume_state is not None:
        resume_state.restore(loop, cluster)
    if engine_params is None:
        # the loop's CURRENT params and step: the init tree for a fresh
        # loop, the trained weights for a restored snapshot
        engine_params = loop.reducer.params
        start_version = loop.step
    engine = ServingEngine(engine_params, cfg, serving=ServingConfig.from_flat(
        max_batch=max_batch, max_seq=max_seq, prompt_cap=prompt_cap,
        temperature=temperature, top_k=top_k, sample_seed=seed,
        start_version=start_version, max_queue=max_queue,
        shed_policy=shed_policy, admission_deadline=admission_deadline,
        page_size=page_size, n_pages=n_pages, prefix_reuse=prefix_reuse,
        decode_kernel=decode_kernel, speculative=speculative),
        device=device)
    versions[int(start_version)] = engine_params
    session = SimulatedServeSession(engine, cost, requests)
    session_box.append(session)

    first = loop.step
    for it in range(iterations):
        if churny:
            _scripted_churn(loop, cluster, first + it + 1, iterations)
        loop.iteration()
        session.advance_to(loop.clock)
    session.drain()
    return {"logs": list(loop.history), "stats": session.stats(),
            "engine": engine, "loop": loop, "cluster": cluster,
            "published": published, "versions": versions,
            "refused": refused, "canary": canary,
            "guardrails": guardrails}


def _scripted_churn(loop, cluster, step: int, iterations: int) -> None:
    """Deterministic membership churn on top of the probabilistic
    straggler: a join a third of the way in, a mid-iteration death at
    two thirds — the fleet the publishes come from is genuinely elastic."""
    from repro_torch.core import JoinEvent
    from repro_torch.core.simulation import DeviceProfile

    if step == max(2, iterations // 3):
        cluster.add_worker("joiner", DeviceProfile("joiner", 250.0, 0.015,
                                                   0.20))
        loop.submit(JoinEvent("joiner", capacity=1 << 20))
    if step == max(3, (2 * iterations) // 3) and "w1" in cluster.workers:
        cluster.kill("w1")


def format_version_histogram(stats) -> List[str]:
    """Render ``stats.versions_served`` as aligned bar lines — the
    CLI-observable face of hot swapping (version == training step)."""
    lines = []
    total = max(sum(stats.versions_served.values()), 1)
    width = 40
    for ver in sorted(stats.versions_served):
        n = stats.versions_served[ver]
        bar = "#" * max(1, round(width * n / total))
        lines.append(f"  v{ver:<6} {n:5d}  {bar}")
    return lines


def main(argv=None):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.serving import generate_requests

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="served/trained arch, reduced unless --full-width "
                         "(default: built-in tiny LM)")
    ap.add_argument("--full-width", action="store_true",
                    help="with --arch: the config at its published widths")
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--publish-every", type=int, default=2)
    ap.add_argument("--T", type=float, default=0.5,
                    help="training iteration budget (s)")
    ap.add_argument("--lr", type=float, default=0.1,
                    help="AdaGrad learning rate")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=10.0,
                    help="open-loop arrival rate (requests/s); spread the "
                         "schedule across the training horizon so "
                         "admissions straddle publishes")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--prompt-cap", type=int, default=16,
                    help="largest prefill bucket; longer prompts chunk")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stable", action="store_true",
                    help="homogeneous fleet, no churn")
    ap.add_argument("--guardrails", action="store_true",
                    help="arm the NaN/divergence watchdog and the "
                         "canary-gated publish")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; overflow sheds")
    ap.add_argument("--shed-policy", default="reject",
                    choices=("reject", "drop_oldest"))
    ap.add_argument("--admission-deadline", type=float, default=None,
                    help="shed queued requests waiting longer than this")
    ap.add_argument("--page-size", type=int, default=0,
                    help=">0: serve from the PAGED KV cache with "
                         "version-keyed prefix reuse")
    ap.add_argument("--pages", type=int, default=0,
                    help="with --page-size: pool size in pages")
    ap.add_argument("--decode-kernel", choices=("flash", "plain"),
                    default="flash",
                    help="decode attention: 'flash' = the CUDA flash-decode "
                         "kernel (its plain version on the CPU), 'plain' = "
                         "masked softmax in PyTorch")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help=">0: speculative decoding with a K-token draft "
                         "(the draft is the SERVED arch at init — "
                         "acceptance is low until training improves it; "
                         "output stays the exact greedy stream)")
    ap.add_argument("--draft-window", type=int, default=32,
                    help="with --speculative: draft context window")
    ap.add_argument("--snapshot-out", default=None,
                    help="save the final TrainState here")
    ap.add_argument("--from-snapshot", default=None,
                    help="resume training AND seed the engine from this "
                         "TrainState snapshot")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch:
        cfg = get_config(args.arch)
        if not args.full_width:
            cfg = cfg.reduced()
    else:
        cfg = tiny_cfg()
    if cfg.arch_type != "dense":
        raise SystemExit(f"train_serve needs an engine-served arch "
                         f"(dense), not {cfg.arch_type}")

    g_hi = max(2, args.max_seq // 4)
    reqs = generate_requests(
        args.requests, rate_rps=args.rate, vocab_size=cfg.vocab_size,
        prompt_rng=(4, max(8, args.max_seq - g_hi - 1)),
        gen_short=(2, max(3, g_hi // 2)), gen_long=(g_hi // 2 + 1, g_hi),
        seed=args.seed + 1)

    engine_params = None
    start_version = 0
    resume_state = None
    if args.from_snapshot:
        from repro_torch.checkpoint.io import (load_train_state,
                                               serving_params_from_train_state)
        resume_state = load_train_state(args.from_snapshot)
        template = tf.init_params(cfg, seed=args.seed, device=device)
        engine_params, start_version = serving_params_from_train_state(
            resume_state, template)
        print(f"seeded engine from {args.from_snapshot} "
              f"(training step {start_version})")

    speculative = None
    if args.speculative > 0:
        from repro_torch.serving import SpeculativeConfig
        speculative = SpeculativeConfig(
            draft_params=tf.init_params(cfg, seed=args.seed + 2,
                                        device=device),
            draft_cfg=cfg, k=args.speculative, window=args.draft_window)

    guardrails = canary = None
    if args.guardrails:
        from repro_torch.core.guardrails import (CanaryGate,
                                                 TrainingGuardrails,
                                                 make_lm_probe)
        from repro_torch.core.simulation import make_lm_problem
        guardrails = TrainingGuardrails()
        (Xp, yp), _ = make_lm_problem(cfg, n_data=32, seq_len=16,
                                      seed=args.seed + 7, device=device)
        canary = CanaryGate(make_lm_probe(cfg, Xp[:8], yp[:8],
                                          device=device))

    out = run_train_serve(
        cfg, reqs, iterations=args.iterations,
        publish_every=args.publish_every, T=args.T, seed=args.seed,
        max_batch=args.max_batch, max_seq=args.max_seq,
        prompt_cap=args.prompt_cap, temperature=args.temperature,
        top_k=args.top_k, churny=not args.stable, lr=args.lr,
        engine_params=engine_params, start_version=start_version,
        resume_state=resume_state, guardrails=guardrails, canary=canary,
        max_queue=args.max_queue, shed_policy=args.shed_policy,
        admission_deadline=args.admission_deadline,
        page_size=args.page_size or None, n_pages=args.pages or None,
        decode_kernel=args.decode_kernel, speculative=speculative,
        device=device)

    logs, stats, engine = out["logs"], out["stats"], out["engine"]
    losses = [lg.loss for lg in logs if lg.loss == lg.loss]
    print(f"train: {len(logs)} iterations, clock={out['loop'].clock:.2f}s, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{len(out['published'])} publishes"
          if losses else f"train: {len(logs)} iterations (no reduces)")
    print(f"serve (simulated clock): {stats.n_requests} requests, "
          f"{stats.gen_tokens} tokens in {stats.makespan:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s), p50={stats.p50_latency:.3f}s "
          f"p95={stats.p95_latency:.3f}s")
    print(f"engine: {stats.engine_steps} steps, {stats.prefill_chunks} "
          f"prefill chunks, {stats.decode_dispatches} decode dispatches, "
          f"{stats.swap_count} swaps, buckets {engine.buckets_seen}, "
          f"device {device}")
    if engine.paged:
        print(f"paged: {engine.n_pages} pages x {engine.page_size} tok, "
              f"peak resident {stats.pages_peak}, prefix hits "
              f"{stats.prefix_hits} ({stats.reused_tokens} reused tokens)")
    if speculative is not None:
        print(f"speculative: drafted {stats.drafted}, accepted "
              f"{stats.accepted} over {stats.spec_rounds} rounds")
    if guardrails is not None:
        print(f"guardrails: {guardrails.n_quarantined} quarantined, "
              f"{guardrails.n_rollbacks} rollbacks, "
              f"evicted {guardrails.evicted or 'none'}; canary "
              f"{canary.n_passed} passed / {canary.n_refused} refused")
    if stats.n_shed or engine.max_queue is not None \
            or args.admission_deadline is not None:
        print(f"backpressure: {stats.n_shed} shed "
              f"({[s.reason for s in stats.shed]}), "
              f"queue peak {stats.queue_peak}")
    print("served version histogram (version == training step):")
    for line in format_version_histogram(stats):
        print(line)
    first = min(stats.completions, key=lambda c: c.rid)
    print(f"sample (rid {first.rid}, v{first.version}):",
          np.asarray(first.tokens[:12]))

    if args.snapshot_out:
        from repro_torch.checkpoint.io import TrainState, save_train_state
        save_train_state(args.snapshot_out,
                         TrainState.capture(out["loop"], out["cluster"]))
        print(f"wrote TrainState snapshot to {args.snapshot_out} "
              f"(step {out['loop'].step})")
    return 0


if __name__ == "__main__":
    main()
