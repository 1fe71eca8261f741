"""Deterministic topic→shard map for the federated bus pool.

One busd hub is the fleet's throughput ceiling and single point of
failure; the reference runs a libp2p gossipsub *mesh* (PAPER.md L2), not
a hub.  The production rebuild shards the bus itself: ``JG_BUS_SHARDS``
busd processes, each owning a deterministic slice of the topic space
(native mirror: ``cpp/common/shardmap.hpp``, kept choice-identical and
golden-tested via ``cpp/probes/codec_golden.cpp --shardmap``).

Ownership rules — every topic is owned by EXACTLY ONE shard:

- region position topics ``mapd.pos.<rx>.<ry>`` (runtime/region.py)
  spread across ALL shards by the region indices:
  ``(rx * 7919 + ry * 104729) % n`` — deterministic from the region
  math alone, so py and cpp clients and every busd agree without any
  coordination;
- a position topic whose suffix is not two decimal ints falls back to
  FNV-1a over the full topic string (still deterministic, still one
  owner);
- everything else — the control plane: ``mapd``, ``mapd.path``,
  ``mapd.metrics``, the ``solver`` plan wire, discovery — lives on the
  designated HOME shard (index 0) and reaches the other shards over
  busd↔busd peering links.

Subscriptions map to the set of shards that may own a matching topic:
an exact topic maps to its single owner; a wildcard (``.*`` suffix,
busd prefix matching) that can match region position topics spans ALL
shards (the wildcard subscriber opens a connection per shard); any
other wildcard stays on the home shard.

``JG_BUS_SHARDS=1`` (the default) is the kill switch: everything maps
to shard 0 and both BusClients keep today's single-hub wire verbatim.

Tenant namespaces: a namespaced wire topic ``<ns>:<topic>``
(runtime/busns.py) is classified by its LOGICAL topic — a tenant's
region beacons spread across the pool and its wildcards span shards
exactly like the un-namespaced fleet's — while the FNV fallback hashes
the full wire topic, so two tenants' odd-suffix position topics still
land on (deterministically) independent shards.
"""

from __future__ import annotations

import os
from typing import List

from p2p_distributed_tswap_tpu_torch.runtime import busns
from p2p_distributed_tswap_tpu_torch.runtime.region import POS_TOPIC_PREFIX

HOME_SHARD = 0
SHARD_PORTS_ENV = "JG_BUS_SHARD_PORTS"
NUM_SHARDS_ENV = "JG_BUS_SHARDS"


def fnv1a32(s: str) -> int:
    """FNV-1a over the UTF-8 bytes of ``s`` (32-bit) — the fallback hash
    for position topics with a non-numeric suffix; byte-identical to the
    C++ mirror."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def _ascii_digits(s: str) -> bool:
    """ASCII decimal digits only — mirrors the C++ ``all_digits``.
    Python's ``str.isdigit`` alone accepts Unicode digit-likes ('³')
    that ``int()`` rejects or (Arabic-Indic digits) that C++ would send
    down the FNV path: either a crash or a routing divergence."""
    return bool(s) and s.isascii() and s.isdigit()


def shard_of(topic: str, num_shards: int) -> int:
    """The single owning shard of ``topic`` in an ``num_shards`` pool.
    ``topic`` may be a namespaced wire topic (``<ns>:<topic>``): the
    logical topic decides the class, the full wire topic feeds the FNV
    fallback."""
    if num_shards <= 1:
        return HOME_SHARD
    logical = busns.strip_ns(topic)
    if logical.startswith(POS_TOPIC_PREFIX) and not logical.endswith("*"):
        suffix = logical[len(POS_TOPIC_PREFIX):]
        rx, dot, ry = suffix.partition(".")
        if dot and _ascii_digits(rx) and _ascii_digits(ry):
            # the region math IS the shard map: deterministic from the
            # region indices, no per-topic state anywhere
            return (int(rx) * 7919 + int(ry) * 104729) % num_shards
        return fnv1a32(topic) % num_shards
    return HOME_SHARD


def shards_for_subscription(topic: str, num_shards: int) -> List[int]:
    """Every shard a subscription to ``topic`` must reach: the owner for
    an exact topic; ALL shards for a wildcard that can match region
    position topics; the home shard otherwise."""
    if num_shards <= 1:
        return [HOME_SHARD]
    if topic.endswith(".*"):
        prefix = busns.strip_ns(topic)[:-1]  # busd matches by this prefix
        # a wildcard spans shards iff some "mapd.pos.…" topic can match
        # it: its prefix extends POS_TOPIC_PREFIX or is a prefix of it
        if prefix.startswith(POS_TOPIC_PREFIX) \
                or POS_TOPIC_PREFIX.startswith(prefix):
            return list(range(num_shards))
        return [HOME_SHARD]
    return [shard_of(topic, num_shards)]


def parse_shard_ports(spec: str) -> List[int]:
    """Parse a ``JG_BUS_SHARD_PORTS`` value ("7450,7451,7452") into the
    ordered shard port list (index = shard id).  Bad entries raise —
    a half-parsed pool map must never route silently."""
    ports = [int(p) for p in spec.split(",") if p.strip()]
    if not ports:
        raise ValueError(f"empty shard port list: {spec!r}")
    if any(p < 1 or p > 65535 for p in ports):
        raise ValueError(f"shard port out of range: {spec!r}")
    return ports


def shard_ports_from_env(default_port: int) -> List[int]:
    """The shard port list the environment advertises, else the single
    ``default_port`` (legacy single-hub wire)."""
    spec = os.environ.get(SHARD_PORTS_ENV, "")
    if spec.strip():
        return parse_shard_ports(spec)
    return [default_port]
