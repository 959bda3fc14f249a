"""Docstring-citation integrity: every RESULTS.md section a docstring
cites must actually exist (a knob shipped citing a
'stage-subsample study' that was never written down; this test makes
that class of drift impossible).

Contract (CLAUDE.md invariant "measured claims in docstrings cite
benchmarks/RESULTS.md rows"): citations of the forms

    benchmarks/RESULTS.md "<phrase>"        (quoted section/table name)
    benchmarks/RESULTS.md <x>[- ]<y> study  (named study)

must match RESULTS.md content as a case-insensitive substring. Loose
prose references ("RESULTS.md cfg5 wall rows") are not checked — only
the two citation forms above carry a checkable section identity.
"""
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
RESULTS = (REPO / "benchmarks" / "RESULTS.md").read_text()

QUOTED = re.compile(r'RESULTS\.md\s+\(?"([^"]+)"')
STUDY = re.compile(r"RESULTS\.md\s+((?:[\w-]+\s+)+?study)")


def _collect_citations():
    cites = []
    for root in ("linearcorex_tpu", "tests", "benchmarks"):
        for path in sorted((REPO / root).rglob("*.py")):
            if path.name == pathlib.Path(__file__).name:
                continue
            text = path.read_text()
            for pat in (QUOTED, STUDY):
                for mobj in pat.finditer(text):
                    phrase = " ".join(mobj.group(1).split())
                    cites.append((str(path.relative_to(REPO)),
                                  text[:mobj.start()].count("\n") + 1,
                                  phrase))
    return cites


CITATIONS = _collect_citations()


def test_citations_were_collected():
    """The extractor keeps finding the known citation population — if a
    refactor changes the citation style wholesale, this trips instead of
    the suite silently checking nothing."""
    phrases = {c[2] for c in CITATIONS}
    assert "stage-subsample study" in phrases
    assert "stage-tol study" in phrases
    assert len(CITATIONS) >= 4


@pytest.mark.parametrize("path,line,phrase",
                         CITATIONS,
                         ids=[f"{p}:{ln}:{ph[:30]}"
                              for p, ln, ph in CITATIONS])
def test_cited_section_exists(path, line, phrase):
    norm = " ".join(RESULTS.split()).lower()
    assert phrase.lower() in norm, (
        f"{path}:{line} cites benchmarks/RESULTS.md \"{phrase}\" but "
        f"RESULTS.md contains no such text — record the measurement "
        f"(or fix the citation) before shipping the claim")
