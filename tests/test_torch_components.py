"""The port's component documents against the JAX package's: its YAML
reader against ``yaml.safe_load``, ``parse_component`` against the JAX
one, the loader's refusals (Resiliency, Chaos, secret refs, malformed
files) and the driver registry's errors and scoping."""

import pathlib

import pytest
import yaml

from tasksrunner.component.loader import load_component_file as jax_load_component_file
from tasksrunner.component.spec import SecretRef
from tasksrunner.component.spec import metadata_bool as jax_metadata_bool
from tasksrunner.component.spec import metadata_int as jax_metadata_int
from tasksrunner.errors import ComponentError as JaxComponentError
from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.component.loader import load_component_file, load_components
from tasksrunner_torch.component.registry import ComponentRegistry, registered_types
from tasksrunner_torch.component.spec import metadata_bool, metadata_int, parse_component
from tasksrunner_torch.errors import ComponentError, ComponentNotFound, DriverNotFound

SAMPLES = pathlib.Path(__file__).resolve().parent.parent / "samples" / "tasks_tracker"
ALL_YAML = sorted(SAMPLES.rglob("*.yaml"))
LOCAL = sorted(p for p in (SAMPLES / "components").glob("*.yaml")
               if yaml.safe_load(p.read_text()).get("kind") == "Component")
CLOUD = sorted((SAMPLES / "aca-components").glob("*.yaml"))


@pytest.mark.parametrize("path", ALL_YAML, ids=lambda p: p.relative_to(SAMPLES).as_posix())
def test_the_reader_gives_what_yaml_safe_load_gives(path):
    text = path.read_text()
    assert blockyaml.load_all(text, str(path)) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("text", [
    "a: 1\nb: [x, 'y, z', 3.5, -2, 0x1f, 017, .inf]\nc: {k: v, n: null, t: yes}\n",
    "- a\n- - b\n  - c\n- k: v\n  j: w\n-\n  deep: [ ]\n",
    "---\n# only a comment\n---\nkey: \"tab\\there \\u00e9\"\nq: 'it''s'\nr: a#b # note\n",
    "outer:\n  inner:\n  - name: x\n    value: '1'\n  other: ~\nempty:\n",
    "",
])
def test_the_reader_matches_yaml_on_the_subset(text):
    assert blockyaml.load_all(text) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("text, line, what", [
    ("a: |\n  block\n", 1, "not supported"),
    ("a: &anchor 1\n", 1, "not supported"),
    ("a:\n\tb: 1\n", 2, "tabs"),
    ("a: plain\n  continued\n", 2, "one line"),
    ("a: [b, [c]]\n", 1, "nested flow"),
    ("when: 2024-01-01\n", 1, "quote it"),
    ("a: 'open\n", 1, "end on its line"),
    ("a: 1\n b: 2\n", 2, "indentation"),
    ("just a scalar line\nkey: value\n", 1, "expected 'key: value'"),
])
def test_the_reader_refuses_what_is_not_in_the_subset(tmp_path, text, line, what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ComponentError, match=f"{path}:{line}: .*{what}"):
        load_component_file(path)


def _fields(spec):
    return (spec.name, spec.type, spec.version, spec.metadata, spec.scopes, spec.block)


@pytest.mark.parametrize("path", LOCAL + CLOUD, ids=lambda p: p.relative_to(SAMPLES).as_posix())
def test_parse_component_matches_the_jax_parser(path):
    (want,) = jax_load_component_file(path)
    if any(isinstance(v, SecretRef) for v in want.metadata.values()):
        # a secret store would resolve it: not ported, so refused
        with pytest.raises(ComponentError, match="secret stores are not ported yet"):
            load_component_file(path)
        return
    (got,) = load_component_file(path)
    assert _fields(got) == _fields(want)
    assert got.source == want.source == str(path)


def test_inline_secrets_resolve_as_in_jax():
    doc = {"componentType": "state.sqlite", "secrets": [{"name": "p", "value": "s3"}],
           "metadata": [{"name": "password", "secretRef": "p"},
                        {"name": "flag", "value": True}, {"name": "n", "value": 3}]}
    from tasksrunner.component.spec import parse_component as jax_parse_component
    want = jax_parse_component(doc, default_name="db")
    got = parse_component(doc, default_name="db")
    assert _fields(got) == _fields(want)
    assert got.metadata == {"password": "s3", "flag": "true", "n": "3"}


@pytest.mark.parametrize("name", ["chaos.yaml", "resiliency.yaml"])
def test_resiliency_and_chaos_documents_are_refused(name):
    with pytest.raises(ComponentError, match="not ported yet"):
        load_component_file(SAMPLES / "components" / name)


def test_a_resources_directory_with_a_chaos_document_is_refused():
    with pytest.raises(ComponentError, match="kind: Chaos documents are not ported yet"):
        load_components(SAMPLES / "components")


def test_secret_key_refs_are_refused(tmp_path):
    path = tmp_path / "store.yaml"
    path.write_text("kind: Component\nmetadata:\n  name: s\nspec:\n  type: state.sqlite\n"
                    "  metadata:\n  - name: password\n    secretKeyRef:\n      name: pw\n"
                    "      key: pw\n")
    with pytest.raises(ComponentError, match="secretKeyRef; secret stores are not ported yet"):
        load_component_file(path)


def test_malformed_documents_fail_as_in_jax():
    from tasksrunner.component.spec import parse_component as jax_parse_component
    for doc, match in (({"kind": "Component", "spec": {}}, "missing spec.type"),
                       ({"componentType": ""}, "missing componentType"),
                       ({"apiVersion": "v1"}, "unrecognised component schema"),
                       ({"componentType": "x", "metadata": {"a": 1}}, "metadata must be a list"),
                       ({"kind": "Component", "spec": {"type": "x"}, "scopes": "a"},
                        "scopes must be a list")):
        with pytest.raises(JaxComponentError, match=match):
            jax_parse_component(doc, default_name="d")
        with pytest.raises(ComponentError, match=match):
            parse_component(doc, default_name="d")


@pytest.mark.parametrize("raw", ["true", "TRUE", "1", "on", "no", "0", "", None, "maybe"])
def test_metadata_bool_matches_jax(raw):
    meta = {} if raw is None else {"k": raw}
    try:
        want = jax_metadata_bool(meta, "k", True)
    except JaxComponentError:
        with pytest.raises(ComponentError):
            metadata_bool(meta, "k", True)
    else:
        assert metadata_bool(meta, "k", True) == want


@pytest.mark.parametrize("raw", ["1024", " 8 ", "", "x"])
def test_metadata_int_matches_jax(raw):
    try:
        want = jax_metadata_int({"k": raw}, "k", 0)
    except JaxComponentError:
        with pytest.raises(ComponentError):
            metadata_int({"k": raw}, "k", 0)
    else:
        assert metadata_int({"k": raw}, "k", 0) == want


def test_registry_scoping_block_and_unknown_types(tmp_path):
    specs = [parse_component({"kind": "Component", "metadata": {"name": n},
                              "spec": {"type": t}, "scopes": s}, default_name=n)
             for n, t, s in (("scores", "state.in-memory", ["priority-scorer"]),
                             ("bus", "pubsub.in-memory", []),
                             ("odd", "bindings.cron", []))]
    reg = ComponentRegistry(specs, app_id="priority-scorer")
    assert reg.names() == ["bus", "odd", "scores"] and reg.names("state") == ["scores"]
    assert reg.get("scores", block="state") is reg.get("scores")
    with pytest.raises(ComponentNotFound, match="not a pubsub component"):
        reg.get("scores", block="pubsub")
    with pytest.raises(DriverNotFound, match="no driver for component type 'bindings.cron'"):
        reg.get("odd")
    other = ComponentRegistry(specs, app_id="some-api")
    with pytest.raises(ComponentNotFound, match="not registered for app 'some-api'"):
        other.get("scores")
    assert {"state.sqlite", "state.azure.cosmosdb", "state.postgresql", "state.in-memory",
            "pubsub.sqlite", "pubsub.azure.servicebus", "pubsub.redis",
            "pubsub.in-memory"} <= set(registered_types())


def test_a_redis_host_is_refused_and_none_falls_back_to_sqlite(tmp_path):
    from tasksrunner_torch.pubsub.sqlite import SqliteBroker

    def spec(meta):
        return parse_component({"componentType": "pubsub.redis", "metadata": [
            {"name": k, "value": v} for k, v in meta.items()]}, default_name="bus")

    with pytest.raises(ComponentError, match="Redis streams broker .* not ported"):
        ComponentRegistry([spec({"redisHost": "localhost:6379"})]).get("bus")
    broker = ComponentRegistry([spec({"brokerPath": str(tmp_path / "b.db")})]).get("bus")
    assert isinstance(broker, SqliteBroker) and broker.path == str(tmp_path / "b.db")
    broker.close_sync()


def test_sharded_or_replicated_stores_are_refused():
    for knob in ("shards", "replicas"):
        spec = parse_component({"componentType": "state.sqlite",
                                "metadata": [{"name": knob, "value": "2"}]}, default_name="s")
        with pytest.raises(ComponentError, match=f"{knob} other than 1 is not ported yet"):
            ComponentRegistry([spec]).get("s")
