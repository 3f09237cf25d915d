"""Collection at the root of the repo. ``local/`` (listed in ``.gitignore``)
holds unpacked checkouts of other commits for side-by-side runs; their test
files share basenames with these, so collecting both breaks every import."""

collect_ignore = ["local"]
