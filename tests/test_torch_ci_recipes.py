"""chip_smoke.py's phase 13 (the fixture CI on the card) keeps its own copy
of the JAX CI's recipe table, because tests/test_all_ocp.py imports JAX.
The copy must equal the original field by field, and the phase must solve
every registered problem but SKIP and the suite of phase 11."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recipe_table_equals_the_jax_ci(smoke):
    import test_all_ocp as ci

    assert sorted(smoke.CI_CONFIG) == sorted(ci.CONFIG)
    for name, cfg in ci.CONFIG.items():
        assert vars(smoke.CI_CONFIG[name]) == vars(cfg), name
    assert vars(smoke.Cfg()) == vars(ci.Cfg())
    assert smoke.CI_SKIP == ci.SKIP
    assert smoke.CI_BETTER_OK == ci.BETTER_OK
    assert smoke.CI_BETTER_BAND == ci.BETTER_BAND


def test_phase13_solves_all_but_skip_and_the_suite(smoke):
    from ctdirect_tpu.problems import problem_names as names_j
    from ctdirect_tpu_torch.problems import problem_names as names_t

    want = sorted(set(names_j()) - smoke.CI_SKIP - set(smoke.SUITE))
    assert smoke.ci_fixtures(names_t()) == want
    assert len(want) == 22
    # the fixtures this slice ported, each checked by verify_structure on the card
    import test_torch_fixtures_more as more

    assert sorted(smoke.CI_NEW) == sorted(more.FIXTURES)
    assert smoke.CI_TRACED in smoke.CI_NEW


def test_oracle_follows_the_jax_ci(smoke):
    """ci_verdict on stand-in solutions: the rtol oracle, BETTER_OK's band
    and success-only where the stored objective is None."""
    from types import SimpleNamespace as NS

    from ctdirect_tpu_torch.problems import get_problem

    def sol(obj, ok=True):
        return NS(objective=obj, successful=ok, message="stand-in")

    gl, tt, sc = get_problem("glider"), get_problem("truck_trailer"), get_problem("schlogl")
    cfg = smoke.CI_CONFIG
    assert smoke.ci_verdict("glider", gl, cfg["glider"], sol(1.25e3 * 1.009)) == ""
    assert "rtol" in smoke.ci_verdict("glider", gl, cfg["glider"], sol(1.25e3 * 1.011))
    assert "not successful" in smoke.ci_verdict("glider", gl, cfg["glider"], sol(1.25e3, ok=False))
    # truck_trailer minimizes: better (lower) within the band passes, 11 % lower does not
    assert smoke.ci_verdict("truck_trailer", tt, cfg["truck_trailer"], sol(55.948)) == ""
    assert "band" in smoke.ci_verdict("truck_trailer", tt, cfg["truck_trailer"], sol(59.28 * 0.89))
    assert "worse" in smoke.ci_verdict("truck_trailer", tt, cfg["truck_trailer"], sol(59.28 * 1.02))
    assert smoke.ci_verdict("schlogl", sc, smoke.Cfg(), sol(123.0)) == ""


def test_card_overrides_are_options_of_phase13_fixtures(smoke):
    """Every card override names a fixture of phase 13 and only IPMOptions
    fields; the override is the JAX CI's own KKT mode."""
    import dataclasses

    from ctdirect_tpu_torch import IPMOptions
    from ctdirect_tpu_torch.problems import problem_names

    fields = {f.name for f in dataclasses.fields(IPMOptions)}
    for name, over in smoke.CI_CARD_OVERRIDES.items():
        assert name in smoke.ci_fixtures(problem_names())
        assert set(over) <= fields
        assert over.get("kkt_mode", "structured") == "structured"
    assert set(smoke.CI_LONGEST_FIRST) <= set(smoke.ci_fixtures(problem_names()))
