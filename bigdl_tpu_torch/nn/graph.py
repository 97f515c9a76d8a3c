"""Functional graph containers (port of ``Node``, ``Input``, ``Graph``,
``StaticGraph``, ``DynamicGraph`` and ``check_duplicate`` in
``bigdl_tpu/nn/graph.py``).

``linear.inputs(a, b)`` (or ``Node(linear)(a, b)``) wires a module after
the nodes ``a`` and ``b``; ``Graph(inputs, outputs)`` walks the wiring in
a topological order fixed at construction and autograd gives the
backward. The order is the JAX package's, node for node: depth first
from each output, each node's predecessors in wiring order, and the
inputs no output reaches (with ``allow_unused_inputs``) put in front.
Each distinct module is registered once, as ``n{i}_{ClassName}`` with
``i`` the index of its first node in that order, so ``params_dict()``
has the JAX tree's keys and ``load_jax_params`` carries the weights
across; a module wired into several nodes appears once in
``params_dict()`` and ``parameters()``, and its gradients add up.
``stop_gradient(names)`` detaches the named nodes' outputs.
The serializer hooks of the JAX graph wait for ROADMAP.md Queue 1 item
12.6 (``Module.save_module`` raises naming it).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Union

from bigdl_tpu_torch.nn.activation import Identity
from bigdl_tpu_torch.nn.module import Module, activity_tensors, with_tensors
from bigdl_tpu_torch.utils.table import Table


class Node:
    """A module wired into a dataflow graph: ``inputs(*nodes)`` appends
    its predecessors and returns the node."""

    _uids = itertools.count(1)

    def __init__(self, module: Module):
        self.module = module
        self.prev: List["Node"] = []
        self._uid = next(Node._uids)

    def inputs(self, *nodes: "Node") -> "Node":
        for n in nodes:
            if not isinstance(n, Node):
                raise TypeError(f"graph inputs must be Nodes, got {type(n)}")
        self.prev.extend(nodes)
        return self

    __call__ = inputs

    @property
    def name(self) -> str:
        return self.module.get_name()

    def __repr__(self):
        return f"Node({self.name})"


def Input() -> Node:
    """A placeholder input node: an ``Identity`` node."""
    return Node(Identity())


def _stopped(activity):
    return with_tensors(activity, iter(
        [t.detach() for t in activity_tensors(activity)]))


class Graph(Module):
    """A directed acyclic graph of modules. ``inputs`` / ``outputs`` are
    Nodes or lists of them; the forward feeds the i-th entry of the input
    to the i-th input node (one input node takes the input whole), gives
    a node of several predecessors ``Table(*their outputs)``, and returns
    the one output or a Table of the outputs."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]],
                 allow_unused_inputs: bool = False):
        super().__init__()
        self.input_nodes = [inputs] if isinstance(inputs, Node) \
            else list(inputs)
        self.output_nodes = [outputs] if isinstance(outputs, Node) \
            else list(outputs)
        self._allow_unused_inputs = allow_unused_inputs
        self._stop_gradient_names: set = set()
        self._topo = self._topo_sort()
        seen = set()
        for i, node in enumerate(self._topo):
            if id(node.module) not in seen:
                seen.add(id(node.module))
                setattr(self, f"n{i}_{type(node.module).__name__}",
                        node.module)

    # ------------------------------------------------------------ structure
    def _topo_sort(self) -> List[Node]:
        order: List[Node] = []
        state: Dict[int, int] = {}  # 0 = visiting, 1 = done

        def visit(node: Node):
            s = state.get(node._uid)
            if s == 1:
                return
            if s == 0:
                raise ValueError(
                    "graph contains a cycle; a graph must be acyclic (the "
                    "JAX package expresses loops with its while-loop ops)")
            state[node._uid] = 0
            for p in node.prev:
                visit(p)
            state[node._uid] = 1
            order.append(node)

        for out in self.output_nodes:
            visit(out)
        for inp in self.input_nodes:
            if state.get(inp._uid) != 1:
                if not self._allow_unused_inputs:
                    raise ValueError(f"input node {inp.name} is not "
                                     "connected to any output")
                state[inp._uid] = 1
                order.insert(0, inp)
        return order

    def node(self, name: str) -> Node:
        """The node whose module is named ``name``."""
        for n in self._topo:
            if n.name == name:
                return n
        raise KeyError(name)

    def stop_gradient(self, names: Sequence[str]) -> "Graph":
        """Detach the outputs of the named nodes: no gradient reaches
        them or what feeds them through this path."""
        known = {n.name for n in self._topo}
        for name in names:
            if name not in known:
                raise KeyError(f"no node named {name}")
        self._stop_gradient_names.update(names)
        return self

    def check_duplicate(self, raise_on_shared: bool = False):
        """The modules wired into more than one node (their gradients
        add up, which is correct here). Raises where distinct modules
        share a name (``node(name)`` would be ambiguous) and, with
        ``raise_on_shared``, where any module is shared."""
        by_id: Dict[int, List[Node]] = {}
        for node in self._topo:
            by_id.setdefault(id(node.module), []).append(node)
        shared = [nodes[0].module for nodes in by_id.values()
                  if len(nodes) > 1]
        name_to_ids: Dict[str, set] = {}
        for node in self._topo:
            name_to_ids.setdefault(node.name, set()).add(id(node.module))
        ambiguous = sorted(n for n, ids in name_to_ids.items()
                           if len(ids) > 1)
        if ambiguous:
            raise ValueError(f"distinct modules share names {ambiguous}; "
                             "rename with set_name() for unambiguous lookup")
        if raise_on_shared and shared:
            raise ValueError(
                f"modules used by multiple nodes: "
                f"{[m.get_name() for m in shared]} (reference checkDuplicate "
                "semantics)")
        return shared

    # ------------------------------------------------------------ execution
    def _out(self, node: Node, activity):
        out = node.module(activity)
        return _stopped(out) if node.name in self._stop_gradient_names \
            else out

    def forward(self, input):
        if len(self.input_nodes) == 1:
            feeds = [input]
        else:
            feeds = list(input)
            if len(feeds) != len(self.input_nodes):
                raise ValueError(f"graph expects {len(self.input_nodes)} "
                                 f"inputs, got {len(feeds)}")
        cache: Dict[int, object] = {}
        for node, x in zip(self.input_nodes, feeds):
            cache[node._uid] = self._out(node, x)
        for node in self._topo:
            if node._uid in cache:
                continue
            if not node.prev:
                raise ValueError(f"node {node.name} has no inputs and is "
                                 "not an input node")
            ins = [cache[p._uid] for p in node.prev]
            cache[node._uid] = self._out(
                node, ins[0] if len(ins) == 1 else Table(*ins))
        outs = [cache[n._uid] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else Table(*outs)


class StaticGraph(Graph):
    """The reference's name for a graph whose order is fixed when it is
    built, which ``Graph``'s is."""


class DynamicGraph(Graph):
    """The reference's lazily scheduled graph; it runs ``Graph``'s fixed
    order, as in the JAX package (kept for imported graphs' names)."""
