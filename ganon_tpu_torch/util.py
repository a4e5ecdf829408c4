"""Shared utilities (logging, file validation, resume states).

Functional equivalent of ``pirovc/ganon:src/ganon/util.py``.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys
import time
import urllib.request


def print_log(text: str = "", quiet: bool = False, end: str = "\n") -> None:
    if not quiet:
        sys.stderr.write(text + end)
        sys.stderr.flush()


def check_file(file) -> bool:
    return bool(file) and os.path.isfile(file) and os.path.getsize(file) > 0


def check_folder(folder) -> bool:
    return bool(folder) and os.path.isdir(folder)


def validate_input_files(
    input_files_folder, input_extension: str = "", quiet: bool = True,
    input_recursive: bool = False,
) -> list[str]:
    """Expand files/folders into a validated file list."""
    valid = []
    for i in input_files_folder:
        if check_file(i):
            valid.append(i)
        elif os.path.isdir(i):
            if not input_extension:
                print_log(
                    "--input-extension is required for directories. Skipping: " + i,
                    quiet,
                )
                continue
            pattern = (
                os.path.join(i, "**", "*" + input_extension)
                if input_recursive
                else os.path.join(i, "*" + input_extension)
            )
            found = [
                f
                for f in sorted(glob.glob(pattern, recursive=input_recursive))
                if check_file(f)
            ]
            valid.extend(found)
        else:
            print_log("Skipping invalid file/folder: " + i, quiet)
    return valid


def rm_files(files) -> None:
    if isinstance(files, str):
        files = [files]
    for f in files:
        if os.path.isfile(f):
            os.remove(f)


def rm_folder(folder) -> None:
    shutil.rmtree(folder, ignore_errors=True)


def set_output_folder(db_prefix: str) -> str:
    return db_prefix + "_files/"


def save_state(state: str, folder: str) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "." + state), "w") as f:
        f.write(str(time.time()))


def load_state(state: str, folder: str) -> bool:
    return os.path.isfile(os.path.join(folder, "." + state))


def clear_states(which: str, folder: str) -> None:
    for state in (
        f"{which}_download", f"{which}_parse", f"{which}_run",
    ):
        rm_files(os.path.join(folder, "." + state))


def find_rep_files(prefix: str):
    if os.path.isfile(prefix + ".rep"):
        return [prefix + ".rep"]
    return sorted(glob.glob(prefix + "*.rep"))


def download(urls: list[str], output_folder: str, quiet: bool = True) -> list[str]:
    """Download urls into a folder; returns local paths."""
    os.makedirs(output_folder, exist_ok=True)
    out = []
    for url in urls:
        local = os.path.join(output_folder, os.path.basename(url))
        if not check_file(local):
            print_log("Downloading " + url, quiet)
            urllib.request.urlretrieve(url, local)
        out.append(local)
    return out
