"""Bus-level namespaces: one busd pool serving many fleets.

A production device pool runs *thousands of concurrent scenarios*; each
scenario (tenant) is a whole fleet — manager, agents, metrics beacons —
that must share the message plane without cross-talk.  The namespace is
a TOPIC PREFIX applied at the BusClient wire boundary:

    logical topic   "mapd.pos.3.4"
    wire topic      "<ns>:mapd.pos.3.4"      (ns from JG_BUS_NS)

Every publish/subscribe a namespaced client makes is prefixed on the
way out and stripped on the way in, so role code (managers, agents,
sim pools) is tenant-agnostic — the C++ mirror lives in
``cpp/common/bus.hpp`` and makes every native binary tenant-ready via
the same ``JG_BUS_NS`` env.  busd itself stays topic-opaque; only its
two topic CLASSIFIERS (droppable-beacon shedding and the shardmap's
region spread / span-wildcard rules) strip the prefix first, so a
tenant's position gossip sheds and shards exactly like the
un-namespaced fleet's (runtime/shardmap.py ≡ cpp/common/shardmap.hpp).

The separator is ``:`` — it cannot appear in any runtime topic, keeps
busd's ``.*`` prefix-wildcard matching intact (``t0:mapd.pos.*``
prefix-matches ``t0:mapd.pos.3.4`` and nothing of tenant t1), and makes
the prefix strippable with one partition.  Namespaced clients advertise
``caps:["ns1"]`` in hello.

Kill switch: ``JG_BUS_NS`` unset/empty = no prefix anywhere — the wire
is byte-identical to the pre-namespace client (pinned in
tests/test_tenant.py).
"""

from __future__ import annotations

import os
from typing import Tuple

NS_ENV = "JG_BUS_NS"
NS_SEP = ":"


def namespace_from_env() -> str:
    """The process's tenant namespace ('' = un-namespaced legacy wire)."""
    return validate(os.environ.get(NS_ENV, ""))


def validate(ns: str) -> str:
    """Reject separators/whitespace that would corrupt topic framing
    (the fast relay frame splits on the first space; the namespace
    strips on the first colon)."""
    if ns and (NS_SEP in ns or " " in ns or "\n" in ns):
        raise ValueError(f"invalid bus namespace {ns!r}")
    return ns


def wire_topic(ns: str, topic: str) -> str:
    """The on-the-wire topic for a logical topic under ``ns``."""
    return f"{ns}{NS_SEP}{topic}" if ns else topic


def split_ns(topic: str) -> Tuple[str, str]:
    """``(namespace, logical_topic)`` of a wire topic ('' when
    un-namespaced)."""
    ns, sep, rest = topic.partition(NS_SEP)
    if sep and ns and " " not in ns:
        return ns, rest
    return "", topic


def strip_ns(topic: str) -> str:
    """The logical topic of a wire topic (classifiers: shardmap,
    droppable-beacon shedding)."""
    return split_ns(topic)[1]
