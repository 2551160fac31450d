"""Interactive HTML graph visualization.

Counterpart of ``pytensor_tpu/d3viz/d3viz.py`` (PyTensor's d3viz/,
d3viz:43 and the bundled js app), host-only HTML on the port's graphs and
``printing.py``: writes a self-contained page (no CDN, works offline)
with

- layered DAG layout (computed host-side from the toposort),
- pan (drag) / zoom (wheel),
- hover tooltips with op, output types and static shapes,
- click to highlight a node's ancestors + descendants,
- a search box filtering by op/variable name,
- inner-graph navigation: ops with inner graphs (Scan, OpFromGraph,
  FusedElemwise) are double-clickable and open the inner fgraph view,
  with breadcrumbs back to the parent (PyTensor's app's nested-graph
  feature),
- optional profile coloring: pass ``profile={node: seconds}`` to shade
  apply nodes by measured cost.

A <pre> debugprint fallback is embedded for text-only consumption.
"""

from __future__ import annotations

import html
import json
from pathlib import Path

from pytensor_tpu_torch.graph.basic import Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph

_KIND_COLORS = {
    "apply": "#9ec5fe",
    "inner": "#c5b3e6",
    "input": "#8fd19e",
    "const": "#ffd27f",
    "output": "#f1919b",
}


def _type_str(v):
    try:
        return str(v.type)
    except Exception:
        return "?"


def _layout(outputs, profile=None):
    """Layered layout: one row per toposort depth."""
    nodes, edges = [], []
    ids: dict[int, int] = {}
    depth: dict[int, int] = {}
    inner_refs = []

    def nid(obj, label, kind, detail=""):
        if id(obj) not in ids:
            ids[id(obj)] = len(ids)
            nodes.append({"id": ids[id(obj)], "label": label[:48],
                          "kind": kind, "detail": detail})
        return ids[id(obj)]

    from pytensor_tpu_torch.graph.traversal import io_toposort

    order = io_toposort([], outputs)
    for node in order:
        d = 0
        for i in node.inputs:
            if i.owner is not None and id(i.owner) in depth:
                d = max(d, depth[id(i.owner)] + 1)
            elif i.owner is None:
                d = max(d, 1)
        depth[id(node)] = d
        has_inner = hasattr(node.op, "fgraph") or hasattr(node.op, "inner_fgraph")
        detail = (f"op: {node.op}\\n"
                  + "\\n".join(f"out[{k}]: {_type_str(o)}"
                               for k, o in enumerate(node.outputs)))
        if profile and node in profile:
            detail += f"\\ntime: {profile[node]*1e3:.3f} ms"
        an = nid(node, str(node.op), "inner" if has_inner else "apply",
                 detail)
        if has_inner:
            inner_refs.append((an, node))
        nodes[an]["y"] = d
        if profile and node in profile:
            nodes[an]["t"] = profile[node]
        for i in node.inputs:
            if i.owner is not None:
                src = ids[id(i.owner)]
            else:
                kind = "const" if isinstance(i, Constant) else "input"
                label = (f"{i}" if kind == "input"
                         else (str(i.data)[:20] if i.data is not None
                               else "const"))
                src = nid(i, label, kind, f"{_type_str(i)}")
                nodes[src]["y"] = 0
            edges.append({"from": src, "to": an})
    for k, o in enumerate(outputs):
        on = nid(("out", k), f"output {k}", "output", _type_str(o))
        nodes[on]["y"] = (depth[id(o.owner)] + 1) if o.owner is not None else 1
        if o.owner is not None:
            edges.append({"from": ids[id(o.owner)], "to": on})
        else:
            src = nid(o, str(o), "input", _type_str(o))
            nodes[src]["y"] = 0
            edges.append({"from": src, "to": on})
    # x positions within each row
    rows: dict[int, list] = {}
    for n in nodes:
        rows.setdefault(n.get("y", 0), []).append(n)
    for y, row in rows.items():
        for i, n in enumerate(row):
            n["x"] = i - len(row) / 2
    return nodes, edges, inner_refs


def _graph_views(graph_like, profile=None):
    """Main view + recursively collected inner-graph views."""
    if isinstance(graph_like, FunctionGraph):
        outputs = graph_like.outputs
    elif isinstance(graph_like, Variable):
        outputs = [graph_like]
    elif hasattr(graph_like, "fgraph"):
        outputs = graph_like.fgraph.outputs
    else:
        outputs = list(graph_like)
    views = {}
    queue = [("main", outputs, "main")]
    seen = set()
    while queue:
        key, outs, title = queue.pop(0)
        if key in seen:
            continue
        seen.add(key)
        nodes, edges, inner_refs = _layout(outs, profile=profile)
        inner_map = {}
        for node_id, node in inner_refs:
            ig = getattr(node.op, "fgraph", None) or getattr(
                node.op, "inner_fgraph", None)
            if ig is None:
                continue
            child = f"{key}/{node_id}"
            inner_map[node_id] = child
            queue.append((child, list(ig.outputs),
                          f"{title} / {node.op}"))
        views[key] = {"title": title, "nodes": nodes, "edges": edges,
                      "inner": inner_map}
    return views


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"/>
<title>pytensor_tpu graph</title>
<style>
 body {{ font-family: sans-serif; margin: 0; }}
 #bar {{ padding: 6px 10px; background: #f4f4f4; border-bottom: 1px solid #ddd; }}
 #bar input {{ width: 220px; }}
 #crumbs a {{ margin-right: 6px; cursor: pointer; color: #06c; }}
 svg {{ width: 100vw; height: calc(100vh - 80px); cursor: grab; }}
 .node rect {{ stroke: #555; stroke-width: 1; rx: 4; }}
 .node text {{ font-size: 11px; pointer-events: none; }}
 .edge {{ stroke: #999; stroke-width: 1.2; fill: none; marker-end: url(#arr); }}
 .dim {{ opacity: 0.12; }}
 #tip {{ position: fixed; background: #222; color: #eee; padding: 6px 8px;
        border-radius: 4px; font-size: 11px; white-space: pre;
        pointer-events: none; display: none; z-index: 9; }}
 #help {{ color: #777; font-size: 11px; }}
</style></head>
<body>
<div id="bar">
  <span id="crumbs"></span>
  <input id="search" placeholder="filter ops / variables"/>
  <span id="help">drag = pan &middot; wheel = zoom &middot; click = highlight
  lineage &middot; double-click purple = open inner graph</span>
</div>
<div id="tip"></div>
<svg id="sv"><defs>
<marker id="arr" viewBox="0 0 10 10" refX="9" refY="5" markerWidth="7"
 markerHeight="7" orient="auto-start-reverse">
<path d="M 0 0 L 10 5 L 0 10 z" fill="#999"/></marker>
</defs><g id="root"></g></svg>
<pre id="fallback" style="display:none">{fallback}</pre>
<script>
const VIEWS = {views};
const COLORS = {colors};
const NS = "http://www.w3.org/2000/svg";
let stack = ["main"];
let tx = 80, ty = 60, scale = 1;
const root = document.getElementById("root");
const tip = document.getElementById("tip");

function heat(t, tmax) {{
  const f = Math.min(1, t / (tmax || 1));
  const g = Math.round(230 - 150 * f);
  return `rgb(255, ${{g}}, ${{g}})`;
}}

function render() {{
  const view = VIEWS[stack[stack.length - 1]];
  root.innerHTML = "";
  const XS = 130, YS = 80;
  const pos = {{}};
  let tmax = 0;
  for (const n of view.nodes) tmax = Math.max(tmax, n.t || 0);
  for (const n of view.nodes)
    pos[n.id] = [n.x * XS, (n.y || 0) * YS];
  const adj = {{}}, radj = {{}};
  for (const e of view.edges) {{
    (adj[e.from] = adj[e.from] || []).push(e.to);
    (radj[e.to] = radj[e.to] || []).push(e.from);
  }}
  for (const e of view.edges) {{
    const p = document.createElementNS(NS, "path");
    const [x1, y1] = pos[e.from], [x2, y2] = pos[e.to];
    p.setAttribute("d", `M ${{x1}} ${{y1 + 14}} C ${{x1}} ${{(y1 + y2) / 2}},`
      + ` ${{x2}} ${{(y1 + y2) / 2}}, ${{x2}} ${{y2 - 14}}`);
    p.setAttribute("class", "edge");
    p.dataset.from = e.from; p.dataset.to = e.to;
    root.appendChild(p);
  }}
  for (const n of view.nodes) {{
    const g = document.createElementNS(NS, "g");
    g.setAttribute("class", "node");
    g.dataset.id = n.id;
    const [x, y] = pos[n.id];
    g.setAttribute("transform", `translate(${{x}}, ${{y}})`);
    const r = document.createElementNS(NS, "rect");
    const w = Math.max(50, 7 * Math.min(n.label.length, 26) + 12);
    r.setAttribute("x", -w / 2); r.setAttribute("y", -13);
    r.setAttribute("width", w); r.setAttribute("height", 26);
    r.setAttribute("fill", n.t ? heat(n.t, tmax) : COLORS[n.kind]);
    const t = document.createElementNS(NS, "text");
    t.setAttribute("text-anchor", "middle"); t.setAttribute("dy", 4);
    t.textContent = n.label.slice(0, 26);
    g.appendChild(r); g.appendChild(t);
    g.onmousemove = ev => {{
      tip.style.display = "block";
      tip.style.left = (ev.clientX + 12) + "px";
      tip.style.top = (ev.clientY + 12) + "px";
      tip.textContent = (n.detail || n.label).replaceAll("\\\\n", "\\n");
    }};
    g.onmouseleave = () => tip.style.display = "none";
    g.onclick = () => highlight(n.id, adj, radj, view);
    if (view.inner[n.id] !== undefined)
      g.ondblclick = () => {{ stack.push(view.inner[n.id]); crumbs(); render(); }};
    root.appendChild(g);
  }}
  apply();
}}

function reach(start, adj) {{
  const seen = new Set([start]); const st = [start];
  while (st.length) {{
    const c = st.pop();
    for (const nb of (adj[c] || [])) if (!seen.has(nb)) {{ seen.add(nb); st.push(nb); }}
  }}
  return seen;
}}

let lit = null;
function highlight(idv, adj, radj, view) {{
  if (lit === idv) {{ lit = null; }} else {{ lit = idv; }}
  const keep = lit === null ? null :
    new Set([...reach(idv, adj), ...reach(idv, radj)]);
  for (const el of root.querySelectorAll(".node"))
    el.classList.toggle("dim", keep !== null && !keep.has(+el.dataset.id));
  for (const el of root.querySelectorAll(".edge"))
    el.classList.toggle("dim", keep !== null &&
      !(keep.has(+el.dataset.from) && keep.has(+el.dataset.to)));
}}

function crumbs() {{
  const c = document.getElementById("crumbs");
  c.innerHTML = "";
  stack.forEach((k, i) => {{
    const a = document.createElement("a");
    a.textContent = VIEWS[k].title.split(" / ").pop() || "main";
    a.onclick = () => {{ stack = stack.slice(0, i + 1); crumbs(); render(); }};
    c.appendChild(a);
    if (i < stack.length - 1) c.append(" \\u203a ");
  }});
}}

function apply() {{
  root.setAttribute("transform",
    `translate(${{tx}}, ${{ty}}) scale(${{scale}})`);
}}
const sv = document.getElementById("sv");
let drag = null;
sv.onmousedown = ev => drag = [ev.clientX - tx, ev.clientY - ty];
sv.onmousemove = ev => {{ if (drag) {{ tx = ev.clientX - drag[0];
  ty = ev.clientY - drag[1]; apply(); }} }};
sv.onmouseup = () => drag = null;
sv.onwheel = ev => {{ ev.preventDefault();
  scale *= ev.deltaY < 0 ? 1.15 : 0.87; apply(); }};
document.getElementById("search").oninput = ev => {{
  const q = ev.target.value.toLowerCase();
  for (const el of root.querySelectorAll(".node")) {{
    const lbl = el.querySelector("text").textContent.toLowerCase();
    el.classList.toggle("dim", q !== "" && !lbl.includes(q));
  }}
}};
crumbs(); render();
</script>
</body></html>
"""


def d3write(graph_like, outfile, profile=None):
    from pytensor_tpu_torch.printing import debugprint

    views = _graph_views(graph_like, profile=profile)
    fallback = html.escape(debugprint(graph_like, file="str"))
    Path(outfile).write_text(
        _TEMPLATE.format(views=json.dumps(views),
                         colors=json.dumps(_KIND_COLORS),
                         fallback=fallback))
    return outfile


def d3viz(graph_like, outfile, copy_deps=True, profile=None, *args, **kwargs):
    """Write a self-contained interactive HTML visualization of a graph
    (pan/zoom, tooltips, lineage highlighting, inner-graph navigation,
    optional per-node profile heat coloring)."""
    return d3write(graph_like, outfile, profile=profile)
