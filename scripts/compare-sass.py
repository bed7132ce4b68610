#!/usr/bin/env python3
"""Which kernels of a CUDA source compile to the same machine code in two
trees of this repository.

    python3 scripts/compare-sass.py OLD_TREE [NEW_TREE] [SOURCE]

Builds ``musicstyletransfer_torch/ops/csrc/SOURCE.cu`` (default
flash_attention_tc) of each tree with the flags of ``ops/_build.py`` and
compares the kernels' SASS (``cuobjdump -sass``, instruction text without
addresses and encodings). For every kernel of OLD_TREE it prints the
NEW_TREE kernel with the same instructions, or that none has them; so a
kernel that gained a template argument (another symbol) is matched by its
code. NEW_TREE defaults to the tree holding this script. Needs nvcc and
cuobjdump (the machine with the card).
"""

import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from musicstyletransfer_torch.ops import _build  # noqa: E402


def sass(tree: str, source: str, out: str) -> dict:
    """{kernel symbol without its namespace: [instructions]} of one build."""
    src = os.path.join(tree, "musicstyletransfer_torch", "ops", "csrc", f"{source}.cu")
    nvcc = _build.find_nvcc()
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", out, src], check=True)
    text = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", out],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            funcs[cur] = []
        elif cur and ";" in line and "/*" in line:
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip())
    return funcs


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    old_tree = os.path.abspath(sys.argv[1])
    new_tree = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else REPO
    source = sys.argv[3] if len(sys.argv) > 3 else "flash_attention_tc"
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(old_tree, source, os.path.join(tmp, "old.so"))
        new = sass(new_tree, source, os.path.join(tmp, "new.so"))
    by_code = {}
    for name, body in new.items():
        by_code.setdefault(tuple(body), []).append(name)
    same = 0
    for name, body in old.items():
        match = by_code.get(tuple(body))
        same += match is not None
        print(f"{name}: {len(body)} instructions; "
              + (f"identical to {', '.join(match)}" if match else "no kernel of the new tree has them"))
    print(f"{source}.cu: {same} of {len(old)} kernels of {old_tree} compile to the same code in "
          f"{new_tree}; the new tree has {len(new)} kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
