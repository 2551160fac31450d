"""map, reduce, foldl and foldr over scan.

Counterpart of ``pytensor_tpu/scan/views.py``, ported whole.
"""

from __future__ import annotations

from pytensor_tpu_torch.scan.basic import scan


def map(fn, sequences, non_sequences=None, truncate_gradient=-1, go_backwards=False,
        mode=None, name=None):
    return scan(fn, sequences=sequences, outputs_info=None, non_sequences=non_sequences,
                truncate_gradient=truncate_gradient, go_backwards=go_backwards, mode=mode,
                name=name)


def reduce(fn, sequences, outputs_info, non_sequences=None, go_backwards=False, mode=None,
           name=None):
    results, updates = scan(fn, sequences=sequences, outputs_info=outputs_info,
                            non_sequences=non_sequences, go_backwards=go_backwards, mode=mode,
                            name=name)
    if isinstance(results, list):
        return [r[-1] for r in results], updates
    return results[-1], updates


def foldl(fn, sequences, outputs_info, non_sequences=None, mode=None, name=None):
    return reduce(fn, sequences, outputs_info, non_sequences, go_backwards=False, mode=mode,
                  name=name)


def foldr(fn, sequences, outputs_info, non_sequences=None, mode=None, name=None):
    return reduce(fn, sequences, outputs_info, non_sequences, go_backwards=True, mode=mode,
                  name=name)
