"""Top-level command orchestration: ``classify`` and ``build``.

Port of ``ganon_tpu.commands``. ``classify``: database detection
(``.hibf`` before ``.ibf`` for each ``--db-prefix``), the engine, then EM
reassignment (``--multiple-matches em``, the default) and the chained
``report`` (every database has a ``.tax`` and ``--skip-report`` is not
given) over the output prefixes, one per ``--batch-reads`` prefix.
``build``: a snapshot of the selected assemblies
(:mod:`ganon_tpu_torch.acquire`), then ``build-custom`` on its files.
"""

from __future__ import annotations

import os

from ganon_tpu_torch.util import check_file, find_rep_files, print_log


def classify(cfg, device="cuda") -> bool:
    """ganon classify: engine (on ``device``) + reassign (EM) + report.

    Several processes (``--distributed``, or ``WORLD_SIZE`` set by a
    launcher such as ``torchrun``): the read files are partitioned per
    process and each writes under ``{output_prefix}.h{rank}``
    (``parallel/multihost.py``); every process waits for the others at
    the end.
    """
    from ganon_tpu_torch.parallel import multihost

    pidx, pcount = multihost.maybe_initialize(
        force=getattr(cfg, "distributed", False))
    try:
        return _classify(cfg, device, pidx, pcount)
    finally:  # a rank that fails still meets the others at the barrier
        multihost.finish()


def _classify(cfg, device, pidx: int, pcount: int) -> bool:
    from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu_torch.parallel import multihost

    read_stride, read_offset = 1, 0
    if pcount > 1:
        (
            cfg.single_reads, cfg.paired_reads, cfg.batch_reads,
            read_stride, read_offset,
        ) = multihost.shard_reads(
            cfg.single_reads, cfg.paired_reads, cfg.batch_reads,
            pidx, pcount,
        )
        cfg.output_prefix = multihost.host_output_prefix(
            cfg.output_prefix, pidx, pcount
        )
        if not (cfg.single_reads or cfg.paired_reads or cfg.batch_reads):
            print_log(
                f"host {pidx}: no input files in this shard", cfg.quiet
            )
            return True
        if read_stride > 1:
            print_log(
                f"host {pidx}: record-range shard {read_offset}/"
                f"{read_stride} of {len(cfg.single_reads)} single + "
                f"{len(cfg.paired_reads) // 2} paired files", cfg.quiet
            )

    filter_files = []
    tax_files = []
    for dbp in cfg.db_prefix:
        if check_file(dbp + ".hibf"):
            filter_files.append(dbp + ".hibf")
        elif check_file(dbp + ".ibf"):
            filter_files.append(dbp + ".ibf")
        else:
            raise ValueError(f"no .ibf/.hibf found for db prefix {dbp}")
        if check_file(dbp + ".tax"):
            tax_files.append(dbp + ".tax")
    # only use tax if all dbs have one (classify.py:24-27)
    if len(tax_files) != len(filter_files):
        tax_files = []

    ecfg = ClassifyConfig(
        ibf=filter_files,
        tax=tax_files,
        single_reads=cfg.single_reads,
        paired_reads=cfg.paired_reads,
        batch_reads=cfg.batch_reads,
        output_prefix=cfg.output_prefix,
        hierarchy_labels=cfg.hierarchy_labels or ["H1"],
        rel_cutoff=cfg.rel_cutoff or [0.75],
        rel_filter=cfg.rel_filter or [0.1],
        fpr_query=cfg.fpr_query or [1e-5],
        skip_lca=cfg.multiple_matches != "lca",
        output_lca=cfg.multiple_matches == "lca" and cfg.output_one,
        output_all=cfg.output_all or cfg.multiple_matches == "em",
        output_unclassified=cfg.output_unclassified,
        output_stats=cfg.output_stats,
        output_single=cfg.output_single,
        tax_root_node=cfg.tax_root_node,
        n_reads=cfg.n_reads,
        pipeline_depth=getattr(cfg, "pipeline_depth", 4),
        top_k_matches=getattr(cfg, "top_k_matches", 128),
        length_bucketing=not getattr(cfg, "no_length_bucketing", False),
        hashes_limit=(1 << 32) - 1 if getattr(cfg, "longreads", False) else 65535,
        read_stride=read_stride,
        read_offset=read_offset,
        quiet=cfg.quiet,
        verbose=cfg.verbose,
        device=str(device),
    )
    run_classify(ecfg)

    if cfg.batch_reads:
        prefixes = set()
        for br in cfg.batch_reads:
            with open(br) as f:
                prefixes.update(
                    cfg.output_prefix + row.split("\t")[0] for row in f
                )
        prefixes = sorted(prefixes)
    else:
        prefixes = [cfg.output_prefix]

    if cfg.multiple_matches == "em":
        from ganon_tpu_torch.reassign import ReassignConfig, reassign

        reassign(
            ReassignConfig(
                input_prefix=list(prefixes),
                remove_all=not cfg.output_all,
                skip_one=not cfg.output_one,
                max_iter=cfg.reassign_max_iter,
                threshold=cfg.reassign_threshold,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )

    if tax_files and not cfg.skip_report:
        from ganon_tpu_torch.report.report import ReportConfig, report

        report(
            ReportConfig(
                input=[
                    str(r) for pre in prefixes for r in find_rep_files(pre)
                ],
                db_prefix=list(cfg.db_prefix),
                min_count=cfg.min_count,
                ranks=cfg.ranks,
                output_format="tsv",
                report_type=cfg.report_type,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )
    return True


def build(cfg, device="cuda") -> bool:
    """ganon build: acquire the reference genomes into ``{db}_files/``,
    then build-custom on the snapshot's files on ``device``
    (build_update.build, build_update.py:29-155). A finished download is
    not repeated (the ``build_download`` state)."""
    import shutil

    from ganon_tpu_torch import acquire
    from ganon_tpu_torch.build import build_custom, check_device, save_config
    from ganon_tpu_torch.config import Config
    from ganon_tpu_torch.util import load_state, save_state, set_output_folder

    check_device(device)
    files_output_folder = set_output_folder(cfg.db_prefix)
    if cfg.restart and os.path.isdir(files_output_folder):
        shutil.rmtree(files_output_folder)
    os.makedirs(files_output_folder, exist_ok=True)

    assembly_summary = os.path.join(files_output_folder,
                                    "assembly_summary.txt")
    if load_state("build_download", files_output_folder) and check_file(
            assembly_summary):
        print_log("Download finished - skipping", cfg.quiet)
    else:
        print_log(
            "Downloading files from " + ",".join(cfg.source) + " ["
            + ",".join(cfg.organism_group if cfg.organism_group
                       else cfg.taxid) + "]",
            cfg.quiet,
        )
        acquire.acquire(
            files_output_folder,
            sources=cfg.source,
            organism_groups=cfg.organism_group,
            taxids=cfg.taxid,
            complete_genomes=cfg.complete_genomes,
            reference_genomes=cfg.reference_genomes,
            top=cfg.top,
            gtdb=cfg.taxonomy == "gtdb",
            threads=getattr(cfg, "threads", 1) or 1,
            quiet=cfg.quiet,
        )
        save_state("build_download", files_output_folder)

    params = {
        "input": [os.path.join(files_output_folder,
                               acquire.current_version(files_output_folder),
                               "files")],
        "input_extension": "fna.gz",
        "input_recursive": True,
        "input_target": "file",
        "ncbi_file_info": [assembly_summary],
    }
    for key in (
        "db_prefix", "level", "taxonomy", "taxonomy_files",
        "genome_size_files", "skip_genome_size", "threads", "max_fp",
        "filter_size", "kmer_size", "window_size", "hash_functions", "mode",
        "min_length", "verbose", "quiet", "filter_type", "write_info_file",
        "keep_files",
    ):
        if hasattr(cfg, key):
            params[key] = getattr(cfg, key)
    bc_cfg = Config("build-custom", **params)
    bc_cfg.validate()
    save_config(bc_cfg, os.path.join(files_output_folder, "config.pkl"))

    ok = build_custom(bc_cfg, which_call="build", device=device)
    if ok:
        print_log("", cfg.quiet)
        print_log(
            files_output_folder + " contains reference sequences and "
            "configuration files. Keep it to update the database later.",
            cfg.quiet,
        )
    return ok
