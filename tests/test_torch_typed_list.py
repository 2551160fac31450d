"""Typed lists in the port against the JAX package.

The cases of ``tests/test_typed_list.py`` built in both packages (the port
on the CPU, in its default mode and under ``"py"``; the JAX package on its
XLA path where it lowers the op, on its numpy oracle where it does not:
``remove``), with the lowerings' host traffic: ``Length`` a host value,
``GetItem`` and ``Insert`` by a constant index reading nothing back, by
an input index reading it, ``Index`` and ``Remove`` reading their answer
back, ``Count`` reading nothing.  Values: float32 within ``2e-6`` of the
largest magnitude, integers equal.
"""

import numpy as np
import pytest

from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.torch.linker import _host_variables
from pytensor_tpu_torch.typed_list import TypedListConstant, TypedListType, TypedListVariable
from tests.torch_control import JAX, PORT, both, held, np_

AV = np.array([1.0, 2.0, 3.0], dtype="float32")
BV = np.array([4.0, 5.0, 6.0], dtype="float32")


def _vecs(p):
    return p.pt.vector("a"), p.pt.vector("b")


def _make_getitem(p):
    a, b = _vecs(p)
    lst = p.tl.make_list([a, b])
    return [a, b], [p.tl.getitem(lst, 0), p.tl.getitem(lst, -1)]


def _getitem_input_index(p):
    a, b = _vecs(p)
    i = p.pt.scalar("i", dtype="int64")
    return [a, b, i], [p.tl.getitem(p.tl.make_list([a, b]), i)]


def _append_extend_insert(p):
    a, b = _vecs(p)
    lst = p.tl.make_list([a])
    lst2 = p.tl.insert(p.tl.extend(p.tl.append(lst, b), lst), 0, a + b)
    return [a, b], [p.tl.length(lst2), p.tl.getitem(lst2, 0)]


def _reverse(p):
    a, b = _vecs(p)
    return [a, b], [p.tl.getitem(p.tl.reverse(p.tl.make_list([a, b])), 0)]


def _count_index(p):
    a, b = _vecs(p)
    lst = p.tl.make_list([a, b, a])
    return [a, b], [p.tl.count(lst, a), p.tl.index_(lst, b)]


def _sugar(p):
    a, b = _vecs(p)
    return [a, b], [p.tl.make_list([a]).append(b).reverse()[0]]


def _in_scan(p):
    a, b = _vecs(p)
    lst = p.tl.make_list([a, b])

    def step(acc, lv):
        return acc + p.tl.getitem(lv, 0) + p.tl.getitem(lv, 1)

    res, _ = p.ptt.scan(step, outputs_info=[p.pt.zeros_like(a)], non_sequences=[lst], n_steps=3)
    return [a, b], [res[-1]]


CASES = {
    "make_getitem": (_make_getitem, lambda: [AV, BV], ["GetItem"]),
    "getitem_input_index": (_getitem_input_index, lambda: [AV, BV, np.int64(1)], []),
    "append_extend_insert": (_append_extend_insert, lambda: [AV, BV], []),
    "reverse": (_reverse, lambda: [AV, BV], []),
    "count_index": (_count_index, lambda: [AV, BV], []),
    "sugar": (_sugar, lambda: [AV, BV], []),
    "in_scan": (_in_scan, lambda: [np.ones(3, "f4"), 2 * np.ones(3, "f4")], []),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port_mode", [None, "PY"])
def test_case_against_the_jax_package(case, port_mode):
    build, values, _ = CASES[case]
    both(build, values(), port_mode=port_mode)


def test_values_as_the_jax_test_expects():
    (r0, r1), _ = both(_make_getitem, [AV, BV])
    held(r0, AV)
    held(r1, BV)
    (n, first), _ = both(_append_extend_insert, [AV, BV])
    assert int(n) == 4
    held(first, AV + BV)
    (c, i), _ = both(_count_index, [AV, BV])
    assert (int(c), int(i)) == (2, 1)
    (r,), _ = both(_in_scan, [np.ones(3, "f4"), 2 * np.ones(3, "f4")])
    held(r, 9 * np.ones(3, "f4"))


def _remove(p):
    a, b = _vecs(p)
    return [a, b], [p.tl.length(p.tl.remove(p.tl.make_list([a, b]), a))]


def test_remove_runs_in_the_port_as_on_the_jax_packages_oracle():
    (n,), _ = both(_remove, [np.ones(3, "f4"), np.zeros(3, "f4")], jax_mode="PY")
    assert int(n) == 1
    ins, outs = _remove(JAX)
    with pytest.raises(Exception, match="data-dependent|oracle"):
        JAX.function(ins, outs[0])(np.ones(3, "f4"), np.zeros(3, "f4"))


def test_index_of_a_missing_element_raises_as_the_oracle():
    for pkg, mode in ((JAX, "PY"), (PORT, None)):
        a, b = _vecs(pkg)
        f = pkg.function([a, b], pkg.tl.index_(pkg.tl.make_list([a]), b),
                         **({"mode": mode} if mode else {}))
        with pytest.raises(ValueError, match="not in typed list"):
            f(AV, BV)


def test_list_inputs_and_outputs():
    lt = TypedListType(PORT.pt.vector("p").type)
    lv = lt("l")
    out = lv.append(PORT.pt.vector("q") * 2)
    q = out.owner.inputs[1].owner.inputs[0]
    f = PORT.function([lv, q], [out, PORT.tl.length(out)])
    got, n = f([AV, BV], AV)
    assert int(n) == 3 and len(got) == 3
    for g, w in zip(got, [AV, BV, 2 * AV]):
        held(g, w)


def test_host_traffic_of_the_lowerings():
    a, b = _vecs(PORT)
    i = PORT.pt.scalar("i", dtype="int64")
    lst = PORT.tl.make_list([a, b])
    length = PORT.tl.length(lst)
    fg = FunctionGraph([a, b, i], [length], clone=False)
    assert length in _host_variables(fg.toposort())

    def reads(outs, ins=(a, b)):
        return PORT.function(list(ins), outs, on_unused_input="ignore").linked.host_reads

    assert reads([PORT.tl.getitem(lst, 1), PORT.tl.count(lst, a), length * 2]) == []
    assert reads([PORT.tl.insert(lst, 0, a)[0]]) == []
    assert len(reads([PORT.tl.getitem(lst, i)], (a, b, i))) == 1
    assert "compared on the host" in reads([PORT.tl.index_(lst, b)])[0]
    assert "compared on the host" in reads([PORT.tl.length(PORT.tl.remove(lst, a))])[0]


def test_variable_sugar_and_constant_class():
    t = TypedListType(PORT.pt.vector("p").type)
    v = t("l")
    assert isinstance(v, TypedListVariable)
    q = PORT.pt.vector("q")
    for method, name in ((lambda: v.append(q), "Append"), (lambda: v[0], "GetItem"),
                         (lambda: v.reverse(), "Reverse"), (lambda: v.count(q), "Count"),
                         (lambda: v.ind(q), "Index"), (lambda: v.extend(v), "Extend"),
                         (lambda: v.insert(0, q), "Insert"), (lambda: v.remove(q), "Remove")):
        assert type(method().owner.op).__name__ == name
    c = t.make_constant([np.ones(2, "f4")])
    assert isinstance(c, TypedListConstant)
    f = PORT.function([], PORT.tl.getitem(c, 0) + 1)
    held(np_(f()), 2 * np.ones(2, "f4"))
    assert str(t) == "TypedList<Tensor(float32, shape=(?))>"
    assert t.values_eq([np.ones(2)], [np.ones(2)]) and not t.values_eq([np.ones(2)], [])
