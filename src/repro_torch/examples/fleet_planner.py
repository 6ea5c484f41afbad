"""Fleet planning walk-through: the joint geometry x mapping x sharding
search over every registered architecture on a Blue Gene/Q pod, with each
plan's communication prediction reproduced *standalone* from the public
primitives (the port of ``examples/fleet_planner.py``).

    PYTHONPATH=src python -m repro_torch.examples.fleet_planner                  # Mira, on the card
    PYTHONPATH=src python -m repro_torch.examples.fleet_planner --pod juqueen --device cpu

The planner has no default pod: ``--pod`` names one of the paper's
machines (``mira``, ``juqueen``, ``sequoia``), planned in torus mode on its
midplanes as the launchers' ``--plan-pod`` does, and each config is priced
with the H100 profile (``repro_torch.analysis.h100``) at its default
budget.  For every config (``--archs``, default all) the planner enumerates
partition geometries, rank mappings (``map_ranks``'s catalogue) and
(data, fsdp, tensor, expert) sharding rules, prices each triple against the
roofline and collective cost models, and emits a ranked :class:`SlicePlan`.
The example then re-derives each winner's comm time outside the planner:
``assign_axes(mapping=)`` + ``COLLECTIVE_TIME`` for the ring collectives,
the flow simulator on the bisection pairing pattern for the data-parallel
pairing, and asserts exact agreement, the paper's "static prediction ==
steady-state simulation" property applied to the whole model fleet.
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional

from repro_torch.configs import all_archs
from repro_torch.core import bgq
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.planner import BGQ_PODS, SlicePlan, bgq_pod, format_table, plan_fleet
from repro_torch.network.collectives import COLLECTIVE_TIME, assign_axes
from repro_torch.network.netsim import simulate_traffic
from repro_torch.network.patterns import bisection_pairing


def reproduce_comm(cand, device: DeviceLike) -> None:
    """Re-derive one plan row's comm time from the public primitives."""
    assignment = assign_axes(
        cand.fabric, cand.rule.mesh_shape,
        order_hint=cand.rule.order_hint, mapping=cand.mapping,
    )
    ring = 0.0
    for axis, collective, vol in cand.traffic:
        ring += COLLECTIVE_TIME[collective](
            vol, assignment.embedding(axis), cand.fabric.link_bw
        )
    assert ring == cand.ring_time, (ring, cand.ring_time)
    pairing = 0.0
    if cand.pair_volume_node > 0.0:
        sim = simulate_traffic(
            cand.node_dims,
            bisection_pairing(cand.node_dims),
            link_bw=cand.fabric.link_bw,
            double_link_on_2=cand.fabric.double_link_on_2,
            device=device,
        )
        pairing = cand.pair_volume_node * sim.makespan
    assert math.isclose(pairing, cand.pairing_time, rel_tol=1e-9, abs_tol=0.0) or (
        pairing == cand.pairing_time == 0.0
    ), (pairing, cand.pairing_time)


def main(argv: Optional[List[str]] = None) -> List[SlicePlan]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pod", choices=sorted(BGQ_PODS), default="mira")
    ap.add_argument("--archs", default=None, help="comma-separated configs (default: every registered one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    archs = args.archs.split(",") if args.archs else sorted(all_archs())
    plans = plan_fleet(archs, pod=bgq_pod(args.pod), wrap_mode="torus",
                       unit_node_dims=bgq.MIDPLANE_DIMS, simulate_top_k=1, device=dev)
    assert len(plans) == len(archs)
    print(f"=== Fleet plans on {args.pod}: one ranked table per architecture ===\n")
    for plan in plans:
        print(format_table(plan, top=4))
        reproduce_comm(plan.best, dev)
        assert plan.simulated_slowdown >= 1.0
        print(
            f"  comm reproduced standalone: ring {plan.best.ring_time * 1e3:.3f} ms"
            f" + pairing {plan.best.pairing_time * 1e3:.3f} ms (exact)\n"
        )
    print(f"all {len(plans)} plans verified: planner comm == assign_axes(mapping=)"
          " + netsim, simulated slowdown >= 1")
    return plans


if __name__ == "__main__":
    main()
