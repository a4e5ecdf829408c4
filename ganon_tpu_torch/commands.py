"""Top-level command orchestration: ``classify``.

Port of ``ganon_tpu.commands.classify``: database detection (``.hibf``
before ``.ibf`` for each ``--db-prefix``), the engine, then EM
reassignment (``--multiple-matches em``, the default) and the chained
``report`` (every database has a ``.tax`` and ``--skip-report`` is not
given) over the output prefixes, one per ``--batch-reads`` prefix.
"""

from __future__ import annotations

from ganon_tpu_torch.util import check_file, find_rep_files


def classify(cfg, device="cuda") -> bool:
    """ganon classify: engine (on ``device``) + reassign (EM) + report."""
    from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify

    if getattr(cfg, "distributed", False):
        raise NotImplementedError(
            "--distributed is not ported yet (ROADMAP queue 1, item 12 "
            "'Multi-GPU')"
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
