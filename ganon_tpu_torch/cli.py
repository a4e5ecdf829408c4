"""CLI entry: ``python -m ganon_tpu_torch.cli <subcommand> ...``.

Takes the same flags as ``ganon_tpu.cli`` (one shared Config).
``classify`` and ``build-custom`` are ported and run on the card
(``main(..., device="cpu")`` runs the plain versions); ``reassign``,
``report`` and ``table`` are host code; ``build`` and ``update`` raise
NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import sys

from ganon_tpu_torch.config import Config
from ganon_tpu_torch.util import print_log

# subcommand -> the ROADMAP queue 1 item that ports it
_NOT_PORTED = {
    "build": "'build and update with offline acquisition'",
    "update": "'build and update with offline acquisition'",
}


def main(which: str = None, cfg=None, device="cuda", **kwargs) -> bool:
    if cfg is None:
        cfg = Config(which, **kwargs)
    cfg.validate()
    if cfg.which == "classify":
        from ganon_tpu_torch.commands import classify

        return classify(cfg, device=device)
    if cfg.which == "build_custom":
        from ganon_tpu_torch.build import build_custom

        return build_custom(cfg, device=device)
    if cfg.which == "reassign":
        from ganon_tpu_torch.reassign import ReassignConfig, reassign

        return reassign(
            ReassignConfig(
                input_prefix=cfg.input_prefix,
                output_prefix=cfg.output_prefix,
                max_iter=cfg.max_iter,
                threshold=cfg.threshold,
                remove_all=cfg.remove_all,
                skip_one=cfg.skip_one,
                skip_rep=cfg.skip_rep,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )
    if cfg.which == "report":
        from ganon_tpu_torch.report.report import ReportConfig, report

        return report(
            ReportConfig(
                input=cfg.input,
                input_extension=cfg.input_extension,
                output_prefix=cfg.output_prefix,
                db_prefix=cfg.db_prefix,
                taxonomy=cfg.taxonomy,
                taxonomy_files=cfg.taxonomy_files,
                genome_size_files=cfg.genome_size_files,
                skip_genome_size=cfg.skip_genome_size,
                report_type=cfg.report_type,
                output_format=cfg.output_format,
                sort=cfg.sort,
                ranks=cfg.ranks,
                min_count=cfg.min_count,
                max_count=cfg.max_count,
                taxids=cfg.taxids,
                names=cfg.names,
                names_with=cfg.names_with,
                top_percentile=cfg.top_percentile,
                no_orphan=cfg.no_orphan,
                normalize=cfg.normalize,
                split_hierarchy=cfg.split_hierarchy,
                skip_hierarchy=cfg.skip_hierarchy,
                keep_hierarchy=cfg.keep_hierarchy,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )
    if cfg.which == "table":
        from ganon_tpu_torch.report.table import TableConfig, table

        return table(
            TableConfig(
                input=cfg.input,
                input_extension=cfg.input_extension,
                output_file=cfg.output_file,
                output_format=cfg.output_format,
                output_value=cfg.output_value,
                rank=cfg.rank,
                header=cfg.header,
                unclassified_label=cfg.unclassified_label,
                filtered_label=cfg.filtered_label,
                skip_zeros=cfg.skip_zeros,
                transpose=cfg.transpose,
                no_root=cfg.no_root,
                min_count=cfg.min_count,
                max_count=cfg.max_count,
                taxids=cfg.taxids,
                names=cfg.names,
                names_with=cfg.names_with,
                top_sample=cfg.top_sample,
                top_all=cfg.top_all,
                min_frequency=cfg.min_frequency,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )
    if cfg.which in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.which} is not ported yet (ROADMAP queue 1, "
            f"{_NOT_PORTED[cfg.which]})"
        )
    raise ValueError(f"unknown subcommand: {cfg.which}")


def main_cli() -> None:
    try:
        ok = main()
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print_log(f"ERROR: {e}")
        sys.exit(1)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main_cli()
