"""Saving graphs and functions, with their shared values apart.

Counterpart of ``pytensor_tpu/misc/pkl_utils.py`` (PyTensor's
misc/pkl_utils.py StripPickler:27 and the zip ``dump``/``load``, which
keep each shared variable's value out of the pickle).  ``dump`` writes a
zip of the pickle and, for each shared variable, its value as a ``.npy``
with its device beside it; ``load`` puts each value back on its recorded
device (or on ``device``), and a recorded device that is absent raises.
A compiled function pickles as what made it (``Function.__reduce__``)
and is linked again when loaded; ``dump_function``/``load_function`` save
it so, and ``load_function`` may link it with another mode or device.
"""

from __future__ import annotations

import io
import pickle
import zipfile

import numpy as np


class StripPickler(pickle.Pickler):
    """A pickler that leaves the tags named in ``tags_to_remove`` (the
    creation trace, a test value) out of the graph's tags."""

    def __init__(self, file, protocol=pickle.HIGHEST_PROTOCOL, extra_tag_to_remove=None):
        super().__init__(file, protocol)
        self.tags_to_remove = ["trace", "test_value", *(extra_tag_to_remove or [])]

    def reducer_override(self, obj):
        from pytensor_tpu_torch.utils import Scratchpad

        if isinstance(obj, Scratchpad):
            kept = {k: v for k, v in obj.__dict__.items() if k not in self.tags_to_remove}
            return _scratchpad, (kept,)
        return NotImplemented


def _scratchpad(d):
    from pytensor_tpu_torch.utils import Scratchpad

    pad = Scratchpad()
    pad.__dict__.update(d)
    return pad


def dump(obj, file_handler, protocol=pickle.HIGHEST_PROTOCOL, persistent_id_prefix="shared"):
    """Write ``obj`` as a zip: the pickle, and each shared variable's value
    as ``<prefix>_<k>.npy`` beside its type, name and device, and the
    shared variables' default updates in a pickle of their own."""
    from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
    from pytensor_tpu_torch.link.torch.convert import to_numpy

    arrays: dict[str, np.ndarray] = {}
    found: dict[int, tuple] = {}

    class _P(pickle.Pickler):
        def persistent_id(self, o):
            if not isinstance(o, SharedVariable):
                return None
            if id(o) not in found:
                key = f"{persistent_id_prefix}_{len(arrays)}"
                found[id(o)] = (key, o)
                arrays[key] = to_numpy(o.storage[0])
            return ("shared_variable", found[id(o)][0], type(o), o.type, o.name, str(o.device))

    buf = io.BytesIO()
    _P(buf, protocol).dump(obj)
    # the default updates, loaded first: a function made again when the
    # object loads finds them; one may read more shared variables
    dbuf = io.BytesIO()
    pickler = _P(dbuf, protocol)
    done = 0
    while done < len(found):
        batch = list(found.values())[done:]
        done = len(found)
        pickler.dump([(sv, sv.default_update) for _, sv in batch])
    pickler.dump(None)
    with zipfile.ZipFile(file_handler, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("pkl", buf.getvalue())
        z.writestr("default_updates", dbuf.getvalue())
        for key, arr in arrays.items():
            abuf = io.BytesIO()
            np.save(abuf, arr, allow_pickle=False)
            z.writestr(f"{key}.npy", abuf.getvalue())


def load(file_handler, device=None):
    """The object ``dump`` wrote, each shared value on its recorded device
    (or on ``device``)."""
    return _load(file_handler, device)


def _load(file_handler, device=None, rebuild=None):
    from pytensor_tpu_torch.link.torch.convert import as_torch, resolve_device
    from pytensor_tpu_torch.utils import np_dtype

    loaded: dict = {}
    with zipfile.ZipFile(file_handler, "r") as z:
        payload = z.read("pkl")

        class _U(pickle.Unpickler):
            def persistent_load(self, pid):
                kind, key, cls, typ, name, recorded = pid
                if kind != "shared_variable":
                    raise pickle.UnpicklingError(f"unknown persistent id {kind}")
                if key not in loaded:
                    where = resolve_device(device if device is not None else recorded)
                    arr = np.load(io.BytesIO(z.read(f"{key}.npy")), allow_pickle=False)
                    if arr.dtype.kind == "V":  # a bfloat16 value saves as raw 2-byte records
                        arr = arr.view(np_dtype(typ.dtype))
                    loaded[key] = cls(typ, as_torch(arr, where), name=name)
                return loaded[key]

            def find_class(self, module, name):
                if rebuild is not None and (module, name) == (
                        "pytensor_tpu_torch.compile.executor", "_rebuild_function"):
                    return rebuild
                return super().find_class(module, name)

        defaults = _U(io.BytesIO(z.read("default_updates")))
        while (batch := defaults.load()) is not None:
            for sv, du in batch:
                sv.default_update = du
        obj = _U(io.BytesIO(payload)).load()
    return obj


def dump_function(fn, file_handler):
    """``dump`` of a compiled function: what made it, with its shared
    values apart."""
    dump(fn, file_handler)


def load_function(file_handler, mode=None, device=None):
    """A function ``dump_function`` wrote, linked again with ``mode``
    (None: the recorded one) for ``device`` (None: the recorded one, and
    the shared values on theirs)."""
    from pytensor_tpu_torch.compile.executor import _rebuild_function

    def rebuild(payload):
        return _rebuild_function(payload, mode=mode, device=device)

    return _load(file_handler, device, rebuild)
