"""Sphinx configuration for the sustaingym_tpu documentation site.

Mirrors the reference's doc tooling (/root/reference/docs/conf.py: Sphinx +
myst_parser over the same markdown page set) for the batched JAX rebuild.
All content pages are plain markdown and readable without a build; this
config exists so `make html` produces the site wherever sphinx +
myst-parser are installed (they are intentionally NOT runtime dependencies
of the package — see pyproject extras).
"""
import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "sustaingym_tpu"
author = "sustaingym_tpu contributors"
copyright = "2026, sustaingym_tpu contributors"

extensions = [
    "myst_parser",           # markdown pages
    "sphinx.ext.napoleon",   # Google-style docstrings
    "sphinx.ext.viewcode",   # [source] links
]

# optional niceties, enabled only when installed so a minimal sphinx
# environment can still build the site
for _opt in ("sphinx_copybutton",):
    try:
        __import__(_opt)
        extensions.append(_opt)
    except ImportError:
        pass

source_suffix = {
    ".rst": "restructuredtext",
    ".md": "markdown",
}
myst_enable_extensions = ["dollarmath", "amsmath"]

exclude_patterns = ["_build"]

try:
    import sphinx_rtd_theme  # noqa: F401
    html_theme = "sphinx_rtd_theme"
except ImportError:
    html_theme = "alabaster"
