"""The conftest's per-test time limit, in an inner pytest session.

The inner session loads ``tests/conftest.py``'s hook through a conftest of
its own that sets the limit to 1 s, and runs two tests on one xdist worker,
as the tier-1 run does: one sleeps 3 s, one passes.
"""

import os
import subprocess
import sys
import xml.etree.ElementTree as ET

CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conftest.py")

INNER_CONFTEST = f'''
import importlib.util

spec = importlib.util.spec_from_file_location("outer_conftest", {CONFTEST!r})
outer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(outer)
outer.LIMIT_S = 1
pytest_runtest_protocol = outer.pytest_runtest_protocol
'''

INNER_TESTS = '''
import time


def test_sleeps():
    time.sleep(3)


def test_passes():
    pass
'''


def test_a_test_past_the_limit_fails_by_name_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(INNER_CONFTEST)
    (tmp_path / "test_inner.py").write_text(INNER_TESTS)
    xml = tmp_path / "inner.xml"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "test_inner.py", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "1", "--dist", "loadfile",
         f"--junitxml={xml}", "--rootdir", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode == 1, run.stdout + run.stderr
    cases = {c.get("name"): c for c in ET.parse(xml).iter("testcase")}
    assert set(cases) == {"test_sleeps", "test_passes"}

    sleeper = cases["test_sleeps"]
    failure = sleeper.find("failure")
    assert failure is not None, run.stdout
    assert "test_inner.py::test_sleeps ran past its 1 s limit" in failure.get("message")
    assert float(sleeper.get("time")) < 2.5

    passer = cases["test_passes"]
    assert passer.find("failure") is None and passer.find("error") is None
    assert passer.find("skipped") is None
