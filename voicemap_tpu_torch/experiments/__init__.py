"""The experiment CLIs on the card, one module for each script of the JAX
package's ``experiments/``: ``train_classifier``, ``train_siamese``,
``evaluate``, ``embed`` and ``visualize_embeddings``.

Each keeps every option of its JAX script with the same name and default,
and adds ``--device {cuda,cpu}`` (default ``cuda``). Each has
``parse_args(argv)`` and ``main(argv=None)``, so that it runs in-process
(``main(["--device", "cpu", ...])``) or as

    python -m voicemap_tpu_torch.experiments.<name> [options]

``main`` prints what the JAX script prints and returns its results.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..train.checkpoints import CheckpointManager
from ..train.loop import init_model
from ..train.state import init_state


def add_device_option(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model, the store and the kernels run "
                        "(cuda: the card's kernels; cpu: their plain versions)")


def restore_model(cfg, num_classes: int, checkpoint_dir: Optional[str], which: str,
                  device) -> Tuple[object, Optional[int]]:
    """The model of ``cfg`` on ``device`` in eval mode, its weights from the
    ``which`` (``best`` or ``latest``) checkpoint under ``checkpoint_dir``
    (its head sized to the checkpoint's) → ``(model, restored step)``; with
    no directory, or none saved there, the seeded random init and ``None``."""
    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir)
        num_classes = mgr.template_num_classes(which, num_classes)
    model = init_model(cfg, num_classes, device, cfg.train.seed)
    step = None
    if mgr is not None:
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        restored = mgr.restore_best(state) if which == "best" else mgr.restore_latest(state)
        step = None if restored is None else restored.step
    return model.eval(), step
