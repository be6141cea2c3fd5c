"""The port's random suggestion engine against the JAX package's.

``kubeflow_tpu_torch/katib/suggestion.py`` carries what kubebench's study
reaches: ``ParameterConfig``, ``parse_parameter_configs`` and
``RandomSuggestion`` behind ``make_suggestion``. Its draws must be the
JAX engine's: ``random.Random(seed)``, one ``sample`` a parameter in
order, over every parameter type, at several seeds and batch sizes.
"""

import pytest

from kubeflow_tpu_torch.katib import suggestion as TS

RAW = [
    {"name": "learning_rate", "parametertype": "double",
     "feasible": {"min": "0.01", "max": "0.3"}},
    {"name": "--num-layers", "parametertype": "INT",
     "feasible": {"min": 2, "max": 9}},
    {"name": "optimizer", "parametertype": "categorical",
     "feasible": {"list": ["sgd", "adam", "ftrl"]}},
    {"name": "batch", "parametertype": "discrete",
     "feasible": {"list": [16, 32, 64]}},
]


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_random_draws_equal_the_jax_engine(seed):
    from kubeflow_tpu.katib import suggestion as JS
    port = TS.make_suggestion("random", TS.parse_parameter_configs(RAW),
                              seed=seed)
    ref = JS.make_suggestion("random", JS.parse_parameter_configs(RAW),
                             seed=seed)
    for n in (1, 3, 5):
        got, want = port.suggest(n), ref.suggest(n)
        assert got == want and len(got) == n
    for a in port.suggest(4):
        assert 0.01 <= a["learning_rate"] <= 0.3
        assert isinstance(a["--num-layers"], int)
        assert a["optimizer"] in ("sgd", "adam", "ftrl")


def test_parameter_configs_parse_and_refuse_as_the_jax_ones():
    from kubeflow_tpu.katib import suggestion as JS
    got = TS.parse_parameter_configs(RAW)
    want = JS.parse_parameter_configs(RAW)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    bad = ([{"name": "x", "feasible": {"min": 2, "max": 1}}],
           [{"name": "x", "parametertype": "double"}],
           [{"name": "x", "parametertype": "categorical"}],
           [{"name": "x", "parametertype": "bool"}])
    for raw in bad:
        with pytest.raises(ValueError) as port_err:
            TS.parse_parameter_configs(raw)
        with pytest.raises(ValueError) as jax_err:
            JS.parse_parameter_configs(raw)
        assert str(port_err.value) == str(jax_err.value)


def test_the_study_interface_and_the_engines_left_out():
    params = TS.parse_parameter_configs(RAW[:1])
    s = TS.make_suggestion("Random", params, seed=3)
    assert isinstance(s, TS.RandomSuggestion)
    a = s.suggest(1)[0]
    s.observe(a, -1.5)
    assert s.observations == [(a, -1.5)]
    for name in ("grid", "hyperband", "bayesian_optimization"):
        with pytest.raises(ValueError, match="StudyJob controller"):
            TS.make_suggestion(name, params)
    with pytest.raises(ValueError, match="unknown suggestion algorithm"):
        TS.make_suggestion("anneal", params)
