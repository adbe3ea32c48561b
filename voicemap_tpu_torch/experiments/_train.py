"""What the two train CLIs share: the held-out subsets, the synthetic corpus,
the TrainConfig fields set from their options, and ``fit`` under a trace."""

from __future__ import annotations


def resolve_val_subsets(args, default):
    """The default held-out subsets only where they exist (or ``--synthetic``
    will write them); else the training store, with a note. An explicit
    ``--val-subsets`` that is missing still fails when it is read."""
    if args.val_subsets is None:
        if args.synthetic:
            return list(default)
        from ..data.index import subset_available

        missing = [s for s in default if not subset_available(args.data_root, s)]
        if missing:
            print(f"note: default val subset(s) {missing} not found under "
                  f"{args.data_root} — gating on the training store "
                  "(overstates accuracy; pass --val-subsets for the "
                  "held-out protocol)")
            return None
        return list(default)
    if [s.lower() for s in args.val_subsets] == ["none"]:
        return None
    return args.val_subsets


def write_synthetic(args) -> None:
    from ..data import synthetic

    spec = synthetic.SyntheticSpec(n_speakers=args.synthetic_speakers,
                                   utterances_per_speaker=args.synthetic_utterances,
                                   container=args.synthetic_container)
    subsets = list(args.subsets) + list(args.val_subsets or [])
    synthetic.generate_corpus(args.data_root, subsets=subsets, spec=spec)
    print(f"synthetic corpus written under {args.data_root}")


def train_flags(args) -> dict:
    """The TrainConfig fields both train CLIs set from their options."""
    return dict(
        batch_size=args.batch_size, learning_rate=args.lr, num_steps=args.num_steps,
        evaluate_every=args.evaluate_every, num_eval_tasks=args.num_eval_tasks,
        n_shot=args.n_shot, k_way=args.k_way, seed=args.seed,
        use_pallas_preprocess=(None if args.pallas_preprocess == "auto"
                               else args.pallas_preprocess == "on"),
        use_fused_block0=(None if args.fused_block0 == "auto" else args.fused_block0 == "on"),
        quant_forward=args.quant_forward, checkpoint_dir=args.checkpoint_dir)


def run_fit(cfg, args):
    """``fit(cfg)`` on ``args.device`` (under ``--profile``'s trace) →
    ``(state, history)``; prints the last record. Run as one of several
    processes (``VOICEMAP_NUM_PROCESSES``, ``VOICEMAP_PROCESS_ID``,
    ``VOICEMAP_COORDINATOR``), it joins their process group first."""
    from ..parallel import distributed
    from ..train.loop import fit
    from ..utils.profiling import trace

    distributed.initialize(device=args.device)
    with trace(args.profile):
        state, history = fit(cfg, device=args.device, max_store_seconds=args.max_store_seconds,
                             dp=args.dp, pipeline=args.pipeline)
    if history:
        print("final:", history[-1])
    return state, history
