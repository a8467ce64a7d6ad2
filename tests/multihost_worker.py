"""Worker for the 2-process multi-host test (test_multihost.py).

Launched as: python multihost_worker.py <process_id> <num_processes>
<coordinator_port> <out_npz>, with a clean env (no inherited PYTHONPATH,
JAX_PLATFORMS=cpu, 4 virtual devices per process).

Each process initializes the distributed runtime, builds the same
deterministic graph, runs the sharded bounded SSSP over the global
mesh (its addressable shards only), and extracts the full candidate
set from the allgathered results — exercising the real DCN code path
(`initialize_distributed`, `jax.make_array_from_callback` with
non-addressable shards, `multihost_utils.process_allgather`).
"""

import sys

import numpy as np


def main() -> None:
    pid, nproc, port, out = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )
    sys.path.insert(0, sys.argv[5])  # repo root

    from matchtigs_tpu.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        sharded_bounded_sssp,
    )

    initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import jax

    assert jax.process_count() == nproc

    from matchtigs_tpu import testing
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes
    from matchtigs_tpu.ops.sssp import extract_packed_candidates

    store, _, k = testing.make_unitig_store(genome_length=5000, k=11, seed=0)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    mask = np.zeros(dg.n_nodes + 1, dtype=bool)
    mask[: len(in_mask)] = in_mask

    mesh = make_mesh()
    assert mesh.devices.size == nproc * len(jax.local_devices())
    sources = np.asarray(out_nodes, dtype=np.int32)
    packed, dist, overflow, srcs = sharded_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=256, mesh=mesh, batch_size=4
    )
    assert dist is None
    real = srcs != dg.n_nodes
    cands = extract_packed_candidates(dg, packed, srcs, real & ~overflow, mask)
    order = np.lexsort((cands.d, cands.v, cands.u))

    # Full mesh pipeline under 2 real processes: small capacity forces the
    # overflow host tail and the threshold forces host routing — both now
    # compute per-process source slices and allgather (the DCN analog of
    # the reference's single-host thread pool); the acceptance sort runs
    # sharded over the global mesh.
    from matchtigs_tpu.algos.greedytigs import GreedytigConfig, compute_greedytigs

    cfg = GreedytigConfig(
        k=k, use_mesh=True, engine="device", batch_size=4,
        initial_capacity=4, max_capacity=4, overflow_mode="host",
        host_route_threshold=1,
    )
    g2 = g.copy()
    tigs = compute_greedytigs(g2, cfg)
    np.savez(
        out,
        u=cands.u[order],
        v=cands.v[order],
        d=cands.d[order],
        n_devices=mesh.devices.size,
        tigs_flat=tigs.flat,
        tigs_offsets=tigs.offsets,
    )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
