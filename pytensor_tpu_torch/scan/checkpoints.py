"""Gradient checkpointing for scan.

Counterpart of ``pytensor_tpu/scan/checkpoints.py``, ported whole.  The
JAX package builds an ordinary scan and tags its op (``tag_remat``); its
lowering wraps the step in ``jax.checkpoint``, which changes nothing for a
symbolic gradient: the reverse scan is a graph of its own and reads the
forward trace, whatever the forward step saved.  The port keeps the tag
and its lowering ignores it, so values and gradients are those of the
plain scan, as in the JAX package; ``save_every_N`` and ``padding`` are
accepted and unused in both.
"""

from __future__ import annotations

from pytensor_tpu_torch.scan.basic import scan


def scan_checkpoints(fn, sequences=None, outputs_info=None, non_sequences=None,
                     name="checkpoint_scan", n_steps=None, save_every_N=10, padding=True):
    """A scan whose op is tagged for rematerialization (``tag_remat``)."""
    results, updates = scan(fn, sequences=sequences, outputs_info=outputs_info,
                            non_sequences=non_sequences, name=name, n_steps=n_steps)
    for o in (results if isinstance(results, list) else [results]):
        if o.owner is not None:
            o.owner.op.tag_remat = True
    return results, updates
