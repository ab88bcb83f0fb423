"""Topology plane: the 2-D ``(outer, inner)`` device hierarchy — the
port of ``ptype_tpu/parallel/topology.py``'s pure-Python part.

Fast links inside a domain (the **inner** leg: NVLink within a node),
slow links between domains (the **outer** leg: the network between
nodes). A hierarchical wire reduce-scatters inside the fast domain,
exchanges only ``1/n_inner`` of the bytes across the slow leg, and
allgathers back out, with the int8+EF wire resolved per leg.

Ported here: the axis-name constants, :class:`LegWire`, and
:class:`Topology`'s geometry, per-leg wire policy, analytic cost and
byte model and JSON/env forms. Not ported yet (ROADMAP A7, the
hierarchical wire): ``Topology.mesh`` and the two-leg collective
bodies; a ``TensorStore`` given a topology raises.

Env/JSON configuration (``Topology.from_env``): ``PTYPE_TOPOLOGY``
accepts ``"2x4"`` shorthand (outer×inner), an inline JSON object, or
``@/path/to/topology.json``; ``PTYPE_TOPOLOGY_RATIO`` overrides the
emulated inner/outer bandwidth ratio.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ptype_tpu_torch.errors import ClusterError

#: The flat data-parallel axis name — the one home of the literal.
DATA_AXIS = "data"
#: Fast intra-domain leg.
INNER_AXIS = "inner"
#: Slow cross-domain leg.
OUTER_AXIS = "outer"

#: Composite flat axis over the hierarchical mesh — stands where the
#: 1-D ``"data"`` axis was (placements, shard index, collectives).
HIER_AXIS = (INNER_AXIS, OUTER_AXIS)

#: ``PTYPE_TOPOLOGY`` env var consulted by :meth:`Topology.from_env`.
TOPOLOGY_ENV = "PTYPE_TOPOLOGY"
RATIO_ENV = "PTYPE_TOPOLOGY_RATIO"

#: Default emulated bandwidths (GB/s), with an 8× inner/outer
#: asymmetry.
DEFAULT_INNER_GBPS = 16.0
DEFAULT_RATIO = 8.0


@dataclasses.dataclass(frozen=True)
class LegWire:
    """Wire policy for ONE leg of the hierarchy.

    ``compress=None`` means exact (fp32) on this leg; ``"bf16"`` halves
    the payload; ``"int8"`` is the block-scaled quantized wire.
    ``q_block=None`` inherits the caller's default block; a smaller
    block means more scales (finer quantization) — the slow leg
    typically runs a SMALLER block than the fast leg since its bytes
    cost ~an order of magnitude more.
    """

    compress: str | None = None
    q_block: int | None = None

    def __post_init__(self):
        if self.compress not in (None, "bf16", "int8"):
            raise ValueError(
                f"LegWire: compress must be None|'bf16'|'int8', "
                f"got {self.compress!r}")
        if self.q_block is not None and int(self.q_block) < 8:
            raise ValueError(
                f"LegWire: q_block must be >= 8, got {self.q_block}")

    def to_json(self) -> dict:
        return {"compress": self.compress, "q_block": self.q_block}

    @staticmethod
    def from_json(obj: dict | None) -> "LegWire":
        if not obj:
            return LegWire()
        return LegWire(compress=obj.get("compress"),
                       q_block=obj.get("q_block"))


@dataclasses.dataclass(frozen=True)
class Topology:
    """The 2-D device hierarchy: ``n_outer`` domains of ``n_inner``
    devices each, with a per-leg bandwidth/latency model and per-leg
    wire policy. Frozen + hashable so it can key ``lru_cache``'d
    compiled programs alongside the mesh."""

    n_outer: int = 1
    n_inner: int = 1
    #: Per-leg bandwidths in GB/s (the repo's measure_* convention:
    #: bytes / 1e9 / seconds).
    inner_gbps: float = DEFAULT_INNER_GBPS
    outer_gbps: float = DEFAULT_INNER_GBPS / DEFAULT_RATIO
    #: Per-leg one-way latencies in microseconds.
    inner_lat_us: float = 1.0
    outer_lat_us: float = 50.0
    inner_wire: LegWire = dataclasses.field(default_factory=LegWire)
    outer_wire: LegWire = dataclasses.field(default_factory=LegWire)
    #: True when the asymmetry is emulated: the cost model
    #: is analytic, not measured — bench records must say so.
    emulated: bool = False

    def __post_init__(self):
        if int(self.n_outer) < 1 or int(self.n_inner) < 1:
            raise ClusterError(
                f"Topology: need n_outer/n_inner >= 1, got "
                f"{self.n_outer}x{self.n_inner}")
        if self.inner_gbps <= 0 or self.outer_gbps <= 0:
            raise ClusterError(
                f"Topology: bandwidths must be > 0, got inner="
                f"{self.inner_gbps} outer={self.outer_gbps}")

    # ------------------------------------------------------- geometry

    @property
    def n(self) -> int:
        """Total device count — the flat axis extent."""
        return int(self.n_outer) * int(self.n_inner)

    @property
    def flat_axis(self) -> tuple:
        """The composite axis standing in for the old flat ``"data"``
        axis on this topology's mesh."""
        return HIER_AXIS

    @property
    def hierarchical(self) -> bool:
        """True when BOTH legs are non-degenerate — i.e. the
        hierarchical decomposition actually changes the wire."""
        return int(self.n_outer) > 1 and int(self.n_inner) > 1

    @property
    def ratio(self) -> float:
        """Inner/outer bandwidth asymmetry — how much more a slow-leg
        byte costs than a fast-leg byte."""
        return float(self.inner_gbps) / float(self.outer_gbps)

    def domain_of_device(self, ordinal: int) -> int:
        """Outer-domain index of a flat device ordinal."""
        return int(ordinal) // int(self.n_inner)

    def domain_of_linear(self, lin: int) -> int:
        """Outer-domain index of a composite-axis linear index
        (``lax.axis_index(("inner", "outer"))`` yields
        ``i_inner * n_outer + i_outer``)."""
        return int(lin) % int(self.n_outer)

    def domains(self) -> list:
        """Device ordinals grouped by domain: ``[[0..n_inner-1], ...]``."""
        ni = int(self.n_inner)
        return [list(range(o * ni, (o + 1) * ni))
                for o in range(int(self.n_outer))]

    # ---------------------------------------------------- wire policy

    def leg_wire(self, leg: str) -> LegWire:
        if leg == INNER_AXIS:
            return self.inner_wire
        if leg == OUTER_AXIS:
            return self.outer_wire
        raise ValueError(f"Topology.leg_wire: unknown leg {leg!r}")

    def resolve_leg(self, leg: str, compress, q_block):
        """Resolve the caller's flat wire settings against this leg's
        policy: the leg's explicit setting wins, else inherit the
        caller's. Returns ``(compress, q_block)``."""
        w = self.leg_wire(leg)
        c = w.compress if w.compress is not None else compress
        qb = w.q_block if w.q_block is not None else q_block
        return c, qb

    # --------------------------------------------- analytic cost model

    def _leg_ms(self, nbytes: float, hops: int, leg: str) -> float:
        gbps = (self.inner_gbps if leg == INNER_AXIS
                else self.outer_gbps)
        lat = (self.inner_lat_us if leg == INNER_AXIS
               else self.outer_lat_us)
        return float(nbytes) / (gbps * 1e6) + hops * lat * 1e-3

    def leg_bytes(self, payload: int, kind: str = "allreduce") -> dict:
        """Per-leg wire bytes for ONE device's share of a ``payload``-
        byte bucket. ``kind``: ``"allreduce"`` (hier RS + outer
        exchange + hier AG) or ``"reduce_scatter"`` (no gather leg).
        The FLAT baseline puts its whole ring on the slow leg (a flat
        ring over a 2-D layout must cross domains), so its entry
        charges everything to ``outer``."""
        p = float(payload)
        ni, no, n = int(self.n_inner), int(self.n_outer), self.n
        rs_in = (ni - 1) / ni * p              # inner reduce-scatter
        ag_in = rs_in if kind == "allreduce" else 0.0
        # Outer leg moves only this device's 1/n_inner chunk.
        if kind == "allreduce":
            out = 2.0 * (no - 1) / no * (p / ni)
        else:
            out = (no - 1) / no * (p / ni)
        factor = (2.0 * (n - 1) / n if kind == "allreduce"
                  else (n - 1) / n)
        return {
            "inner": rs_in + ag_in,
            "outer": out,
            "flat_outer": factor * p,
        }

    def flat_allreduce_ms(self, payload: int) -> float:
        """Analytic step cost of the FLAT ring allreduce on this
        topology: every hop of a flat ring over the 2-D layout crosses
        a domain boundary somewhere, so all bytes price at the slow
        leg."""
        n = self.n
        return self._leg_ms(2.0 * (n - 1) / n * payload,
                            2 * (n - 1), OUTER_AXIS)

    def hier_allreduce_ms(self, payload: int) -> float:
        """Analytic step cost of the hierarchical decomposition:
        inner reduce-scatter + outer exchange of ``1/n_inner`` of the
        bytes + inner allgather. Legs serialize (the fused program
        orders them), so costs add."""
        b = self.leg_bytes(payload, "allreduce")
        ni, no = int(self.n_inner), int(self.n_outer)
        rs = self._leg_ms(b["inner"] / 2.0, ni - 1, INNER_AXIS)
        ex = self._leg_ms(b["outer"], 2 * (no - 1), OUTER_AXIS)
        ag = self._leg_ms(b["inner"] / 2.0, ni - 1, INNER_AXIS)
        return rs + ex + ag

    def flat_reduce_scatter_ms(self, payload: int) -> float:
        n = self.n
        return self._leg_ms((n - 1) / n * payload, n - 1, OUTER_AXIS)

    def hier_reduce_scatter_ms(self, payload: int) -> float:
        b = self.leg_bytes(payload, "reduce_scatter")
        ni, no = int(self.n_inner), int(self.n_outer)
        return (self._leg_ms(b["inner"], ni - 1, INNER_AXIS)
                + self._leg_ms(b["outer"], no - 1, OUTER_AXIS))

    # ---------------------------------------------------------- config

    def describe(self) -> dict:
        """Geometry + model summary — rides bench tail records and the
        ``obs topo`` view so numbers are comparable across runs."""
        return {
            "n_outer": int(self.n_outer),
            "n_inner": int(self.n_inner),
            "n": self.n,
            "geometry": f"{int(self.n_outer)}x{int(self.n_inner)}",
            "inner_gbps": float(self.inner_gbps),
            "outer_gbps": float(self.outer_gbps),
            "bandwidth_ratio": self.ratio,
            "emulated": bool(self.emulated),
        }

    def to_json(self) -> dict:
        out = self.describe()
        out.pop("n", None)
        out.pop("geometry", None)
        out.pop("bandwidth_ratio", None)
        out.update({
            "inner_lat_us": float(self.inner_lat_us),
            "outer_lat_us": float(self.outer_lat_us),
            "inner_wire": self.inner_wire.to_json(),
            "outer_wire": self.outer_wire.to_json(),
        })
        return out

    @staticmethod
    def from_json(obj: dict) -> "Topology":
        kw = {}
        for k in ("n_outer", "n_inner"):
            if k in obj:
                kw[k] = int(obj[k])
        for k in ("inner_gbps", "outer_gbps", "inner_lat_us",
                  "outer_lat_us"):
            if k in obj:
                kw[k] = float(obj[k])
        if "emulated" in obj:
            kw["emulated"] = bool(obj["emulated"])
        if "inner_wire" in obj:
            kw["inner_wire"] = LegWire.from_json(obj["inner_wire"])
        if "outer_wire" in obj:
            kw["outer_wire"] = LegWire.from_json(obj["outer_wire"])
        return Topology(**kw)

    @staticmethod
    def emulated_host(n_outer: int, n_inner: int,
                      ratio: float = DEFAULT_RATIO,
                      inner_gbps: float = DEFAULT_INNER_GBPS,
                      **kw) -> "Topology":
        """Emulation: the geometry is real (the ranks),
        the bandwidth asymmetry is the analytic model — deterministic,
        no sleep injection, so CPU benches are reproducible."""
        return Topology(n_outer=int(n_outer), n_inner=int(n_inner),
                        inner_gbps=float(inner_gbps),
                        outer_gbps=float(inner_gbps) / float(ratio),
                        emulated=True, **kw)

    @staticmethod
    def from_env(env: dict | None = None,
                 n_devices: int | None = None) -> "Topology | None":
        """Read ``PTYPE_TOPOLOGY``: ``"OxI"`` shorthand (``"2x4"`` =
        2 domains × 4 devices), inline JSON, or ``@path`` to a JSON
        file. Returns ``None`` when unset (callers fall back to the
        flat axis). ``PTYPE_TOPOLOGY_RATIO`` overrides the emulated
        bandwidth ratio for the shorthand form."""
        env = os.environ if env is None else env
        raw = (env.get(TOPOLOGY_ENV) or "").strip()
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                return Topology.from_json(json.load(f))
        if raw.startswith("{"):
            return Topology.from_json(json.loads(raw))
        try:
            o_s, i_s = raw.lower().split("x", 1)
            n_outer, n_inner = int(o_s), int(i_s)
        except ValueError:
            raise ClusterError(
                f"{TOPOLOGY_ENV}={raw!r}: want 'OUTERxINNER' (e.g. "
                "'2x4'), inline JSON, or @/path/to.json") from None
        ratio = float(env.get(RATIO_ENV) or DEFAULT_RATIO)
        return Topology.emulated_host(n_outer, n_inner, ratio=ratio)

