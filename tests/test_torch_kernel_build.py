"""The kernel build's cache key covers every header a library includes.

``ops/kernel_build.library_path`` names each built library by a hash of its
source and of the headers that ``LIBRARIES`` lists for it. A header missing
from that list would leave a stale cached library after an edit to the
header, so each list must equal the transitive closure of the source's
``#include "..."`` lines under ``csrc/``. The same holds for the check
libraries that only the card tests build (``CHECK_LIBRARIES``, sources
under ``tests/csrc/``). Runs on the CPU: it reads the sources and builds
nothing.
"""

import re
from pathlib import Path

import pytest

from graph_physics_tpu_torch.ops import kernel_build

#: the card tests' own libraries, outside the port's LIBRARIES:
#: name -> (source, the headers under csrc/ it includes), for
#: kernel_build.load's ``source``
CHECK_LIBRARIES = {
    "wgmma_check": (Path(__file__).resolve().parent / "csrc" / "wgmma_check.cu",
                    ("wgmma_common.cuh",)),
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _include_closure(src: str) -> set:
    """Every header under csrc/ that ``src`` includes, directly or through
    another header."""
    seen, todo = set(), [src]
    while todo:
        for header in _INCLUDE.findall((kernel_build.CSRC / todo.pop()).read_text()):
            assert (kernel_build.CSRC / header).is_file(), f"{header} is not under csrc/"
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return seen


@pytest.mark.parametrize("name", sorted(kernel_build.LIBRARIES) + sorted(CHECK_LIBRARIES))
def test_library_headers_are_the_include_closure_of_its_source(name):
    src, headers = kernel_build.LIBRARIES.get(name) or CHECK_LIBRARIES[name]
    assert len(set(headers)) == len(headers), f"{name}: a header is listed twice"
    assert set(headers) == _include_closure(src)
