"""Top-level command orchestration: ``classify`` (flat-IBF slice).

Port of ``ganon_tpu.commands.classify``: database detection, then the
engine. Reassignment (``--multiple-matches em``) and the chained
``report`` are not ported yet and raise before any work starts.
"""

from __future__ import annotations

from ganon_tpu_torch.util import check_file


def classify(cfg) -> bool:
    """ganon classify: engine (reassign and report are not ported yet)."""
    from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify

    if getattr(cfg, "distributed", False):
        raise NotImplementedError(
            "--distributed is not ported yet (ROADMAP queue 1, item 12 "
            "'Multi-GPU')"
        )
    if cfg.multiple_matches == "em":
        raise NotImplementedError(
            "--multiple-matches em needs reassign, which is not ported yet "
            "(ROADMAP queue 1, 'reassign (EM) and report without pandas'); "
            "use --multiple-matches lca or skip"
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
    if tax_files and not cfg.skip_report:
        raise NotImplementedError(
            "classify chains 'report' when the database has a .tax, and "
            "report is not ported yet (ROADMAP queue 1, 'reassign (EM) and "
            "report without pandas'); pass --skip-report"
        )

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
        output_all=cfg.output_all,
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
    )
    run_classify(ecfg)
    return True
