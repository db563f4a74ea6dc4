"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax


def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge

    from blasr_jax.pipeline.mapper import unpack_result

    fn, args = ge.entry()
    res = jax.jit(fn)(*args)
    jax.block_until_ready(res)
    host = unpack_result(res, 2)
    assert host.sel_valid.sum() >= 4


def test_sharded_matches_single_device():
    """SPMD result must equal the single-device result."""
    import __graft_entry__ as ge
    from blasr_jax.parallel.mesh import make_mesh, sharded_map_batch
    from blasr_jax.pipeline.mapper import make_device_index, _map_batch_impl

    index, params, codes, lengths = ge._tiny_problem(n_reads=8, seed=5)
    di = make_device_index(index, params)

    single = _map_batch_impl(
        codes, lengths,
        di.genome_pad, di.arrays, di.starts,
        params=params, pad=di.pad, k=di.k, genome_len=di.genome_len,
        index_kind=di.kind, fm_n=di.fm_n,
    )
    mesh = make_mesh(4)
    multi = sharded_map_batch(mesh, di, params, codes, lengths)
    np.testing.assert_array_equal(np.asarray(single.sel_ints), np.asarray(multi.sel_ints))
    np.testing.assert_array_equal(np.asarray(single.read_ints), np.asarray(multi.read_ints))
    np.testing.assert_array_equal(
        np.asarray(single.moves_packed), np.asarray(multi.moves_packed)
    )


def test_cli_mesh_matches_single_device(tmp_path):
    """-ndevices 8 through the production runner/CLI must produce
    byte-identical m4 to the default single-device path (VERDICT: the
    serving path, not just the kernels, must use the mesh)."""
    from blasr_jax.cli.blasr import main as blasr_main
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(50_000, seed=77, repeat_fraction=0.0)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("ref", g)])
    reads, _ = simulate_reads(g, 24, mean_len=400, seed=78)
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])

    common = [rp, gp, "-m", "4", "-batchSize", "8", "-maxReadLen", "1024",
              "-minMatch", "13"]
    o1 = str(tmp_path / "one.m4")
    o8 = str(tmp_path / "eight.m4")
    blasr_main(common + ["-out", o1])
    blasr_main(common + ["-out", o8, "-ndevices", "8"])
    assert open(o1).read() == open(o8).read()
