"""NCBI E-utilities client without pandas: accession to length, taxid
and assembly.

Port of ``ganon_tpu.eutils``, the batch e-utils driver of the reference
(``pirovc/ganon:scripts/ganon-get-seq-info.sh``, driven by
``tax_util.run_eutils``): batches of 200 accessions, 3 attempts with
linear backoff, esummary first with efetch for what it missed (length
and taxid), elink then esummary for the linked assembly's accession and
name, ``None`` for what could not be resolved, the input order kept.

The endpoint is the ``eutils_url`` environment variable (or the
``base_url`` argument), so tests run against a local stub server; an NCBI
API key from ``ncbi_api_key`` (or ``api_key``) is appended when given.
"""

from __future__ import annotations

import os
import re
import time
import urllib.parse
import urllib.request

from ganon_tpu_torch.util import print_log

EUTILS_URL = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils"
BATCH = 200
ATTEMPTS = 3


class EUtils:
    def __init__(self, base_url: str | None = None, api_key: str = "",
                 batch: int = BATCH, attempts: int = ATTEMPTS,
                 quiet: bool = True):
        self.base_url = (base_url or os.environ.get("eutils_url")
                         or EUTILS_URL).rstrip("/")
        self.api_key = api_key or os.environ.get("ncbi_api_key", "")
        self.batch = batch
        self.attempts = attempts
        self.quiet = quiet

    def _get(self, endpoint: str, params: dict) -> str:
        if self.api_key:
            params = dict(params, api_key=self.api_key)
        url = f"{self.base_url}/{endpoint}?" + urllib.parse.urlencode(
            params, doseq=True)
        with urllib.request.urlopen(url) as r:
            return r.read().decode()

    def _retry(self, fn, check):
        """``attempts`` tries with linear backoff (none off NCBI's host);
        None when every try failed or missed ``check``."""
        for i in range(1, self.attempts + 1):
            try:
                out = fn()
                if check(out):
                    return out
            except Exception:
                pass
            if i < self.attempts:
                time.sleep(i if self.base_url.startswith("https://eutils")
                           else 0)
        return None

    def length_taxid(self, accessions: list[str]) -> dict[str, tuple]:
        """{accession: (length, taxid)}; unresolved accessions are
        absent."""
        out = {}
        for start in range(0, len(accessions), self.batch):
            chunk = accessions[start:start + self.batch]
            xml = self._retry(
                lambda: self._get("esummary.fcgi", {
                    "db": "nuccore", "id": ",".join(chunk)}),
                lambda x: 'Name="AccessionVersion"' in x,
            )
            got = {}
            if xml:
                accs = re.findall(
                    r'Name="AccessionVersion" Type="String">([^<]+)', xml)
                lens = re.findall(r'Name="Length" Type="Integer">([^<]+)', xml)
                taxs = re.findall(r'Name="TaxId" Type="Integer">([^<]+)', xml)
                got = dict(zip(accs, zip(lens, taxs)))
            missing = [a for a in chunk if a not in got]
            if missing:
                xml = self._retry(
                    lambda: self._get("efetch.fcgi", {
                        "db": "nuccore", "rettype": "fasta",
                        "retmode": "xml", "id": ",".join(missing)}),
                    lambda x: "<TSeq_accver>" in x,
                )
                if xml:
                    accs = re.findall(r"<TSeq_accver>([^<]+)", xml)
                    lens = re.findall(r"<TSeq_length>([^<]+)", xml)
                    taxs = re.findall(r"<TSeq_taxid>([^<]+)", xml)
                    got.update(dict(zip(accs, zip(lens, taxs))))
            out.update(got)
        return out

    def assembly_info(self, accessions: list[str]) -> dict[str, tuple]:
        """{accession: (assembly_accession, assembly_name)}."""
        out = {}
        for start in range(0, len(accessions), self.batch):
            chunk = accessions[start:start + self.batch]
            xml = self._retry(
                lambda: self._get("elink.fcgi", {
                    "dbfrom": "nuccore", "db": "assembly",
                    "linkname": "nuccore_assembly", "id": chunk}),
                lambda x: "<LinkSet>" in x,
            )
            if not xml:
                continue
            # one <LinkSet> per id=, in input order
            linksets = re.findall(r"<LinkSet>(.*?)</LinkSet>", xml, re.S)
            acc_uid = {}
            for acc, ls in zip(chunk, linksets):
                m = re.search(
                    r"<LinkName>nuccore_assembly</LinkName>\s*<Link>\s*"
                    r"<Id>(\d+)</Id>", ls)
                if m and "ERROR" not in ls:
                    acc_uid[acc] = m.group(1)
            if not acc_uid:
                continue
            xml = self._retry(
                lambda: self._get("esummary.fcgi", {
                    "db": "assembly",
                    "id": ",".join(sorted(set(acc_uid.values())))}),
                lambda x: "DocumentSummary uid=" in x,
            )
            if not xml:
                continue
            uid_info = {}
            for uid, body in re.findall(
                    r'DocumentSummary uid="(\d+)"(.*?)</DocumentSummary>',
                    xml, re.S):
                cur = re.search(r"<AssemblyAccession>([^<]+)", body)
                # the latest assembly accession when there is one
                latest = re.search(r"<LatestAccession>([^<]+)", body)
                found = latest or cur
                name = re.search(r"<Organism>([^<]+)", body)
                uid_info[uid] = (found.group(1) if found else None,
                                 name.group(1) if name else None)
            for acc, uid in acc_uid.items():
                if uid in uid_info:
                    out[acc] = uid_info[uid]
        return out


def run_eutils(info, build_output_folder: str, skip_taxid: bool = False,
               level: str = "", base_url: str | None = None,
               quiet: bool = True) -> dict[str, dict]:
    """``{target: {node[, specialization, specialization_name]}}`` for the
    targets of ``info`` (an iterable of them, or the build's ``{target:
    row}`` table), in its order, ``None`` where nothing was resolved: the
    JAX package's DataFrame, whose missing values are NaN."""
    targets = list(info)
    client = EUtils(base_url=base_url, quiet=quiet)
    out: dict[str, dict] = {t: {} for t in targets}
    if not skip_taxid:
        lt = client.length_taxid(targets)
        for t in targets:
            out[t]["node"] = lt[t][1] if t in lt else None
        missing = sum(t not in lt for t in targets)
        if missing:
            print_log(f" - failed to get taxid/length for {missing} "
                      "accessions", quiet)
    if level == "assembly":
        ai = client.assembly_info(targets)
        for t in targets:
            out[t]["specialization"], out[t]["specialization_name"] = (
                ai.get(t, (None, None)))
    return out
