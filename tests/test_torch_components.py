"""The port's component documents against the JAX package's: its YAML
reader against ``yaml.safe_load``, ``parse_component`` against the JAX
one (secret refs included), the loader's refusals (Chaos, malformed
files; a Resiliency document is skipped, a secret ref that resolves
nowhere is refused when the component is built) and the driver
registry's errors and scoping."""

import pathlib

import pytest
import yaml

from tasksrunner.component.loader import load_component_file as jax_load_component_file
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


def _folded_doc(seed: int) -> dict:
    """A run-file-shaped document whose strings are long, spaced, and
    hold quotes, escapes, newlines and non-ASCII text: what PyYAML folds
    over lines or quotes."""
    import random

    rng = random.Random(seed)
    words = ["alpha", "beta", "x", "key: v", "a #b", "'", '"', "\\", "\n", "\n\n", "é",
             "\t", "yes", "12", "-", "  ", "\x85", "\u2028", "😀", "\xa0"]
    texts = [" ".join(rng.choice(words) for _ in range(rng.randint(8, 40))) for _ in range(4)]
    return {"apps": [{"app_id": "priority-scorer", "env": {"LONG": texts[0], "B": texts[1]},
                      "grants": {"bus": [{"subscribe": [texts[2]]}]}}],
            "base_dir": texts[3], "list": texts}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("style", [{}, {"width": 20}, {"allow_unicode": True},
                                   {"default_style": "'"}, {"default_style": '"'}])
def test_the_reader_reads_what_yaml_safe_dump_folds_over_lines(seed, style):
    text = yaml.safe_dump(_folded_doc(seed), sort_keys=False, **style)
    assert any(line.startswith("    ") and not line.lstrip().startswith(("-", "'", '"'))
               or line.endswith("\\") for line in text.splitlines()) or style
    assert blockyaml.load_all(text) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("seed", range(6))
def test_the_writer_writes_what_both_readers_read_back(seed):
    doc = {**_folded_doc(seed), "n": [1, -2, 0.5, 1e-05, None, True, False, "", "=", "<<",
                                      "2024-01-01", "1:30", "~", "null", "0x1f", "-x", {}, []]}
    text = blockyaml.dump(doc)
    assert yaml.safe_load(text) == doc == blockyaml.load_all(text)[0]
    assert blockyaml.load_all(blockyaml.dump_all([doc, {"k": "v"}])) == [doc, {"k": "v"}]


@pytest.mark.parametrize("text, line, what", [
    ("a: |\n  block\n", 1, "not supported"),
    ("a: &anchor 1\n", 1, "not supported"),
    ("a:\n\tb: 1\n", 2, "tabs"),
    ("a: [b]\n  continued\n", 2, "one line"),
    ("a: [b, [c]]\n", 1, "nested flow"),
    ("when: 2024-01-01\n", 1, "quote it"),
    ("a: 'open\n", 1, "end on its line"),
    ("a: 'open\nb: 1'\n", 2, "indented deeper"),
    ("a: plain\n  continued: no\n", 2, "indentation"),
    ("a: plain # note\n  continued\n", 2, "one line"),
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
    (got,) = load_component_file(path)
    assert _fields(got)[:3] == _fields(want)[:3] and _fields(got)[4:] == _fields(want)[4:]
    # a secret ref, left for the registry to resolve, is the same ref
    assert {k: v if isinstance(v, str) else ("ref", v.key, v.store)
            for k, v in got.metadata.items()} == {
        k: v if isinstance(v, str) else ("ref", v.key, v.store)
        for k, v in want.metadata.items()}
    assert (got.secret_store, got.inline_secrets) == (want.secret_store, want.inline_secrets)
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
    """A Chaos document is refused (not ported); a Resiliency document is
    no component: skipped here, as the JAX loader skips it, and read by
    ``load_resiliency`` instead."""
    path = SAMPLES / "components" / name
    if name == "chaos.yaml":
        with pytest.raises(ComponentError, match=r"not ported yet \(ROADMAP A23\)"):
            load_component_file(path)
        return
    from tasksrunner_torch.resiliency import load_resiliency

    assert load_component_file(path) == jax_load_component_file(path) == []
    assert [s.name for s in load_resiliency(path.parent)] == ["tasks-tracker-resiliency"]


def test_a_resources_directory_with_a_chaos_document_is_refused():
    with pytest.raises(ComponentError, match="kind: Chaos documents are not ported yet"):
        load_components(SAMPLES / "components")


def test_secret_key_refs_are_refused(tmp_path):
    """A ``secretKeyRef`` to a store the app has not is refused when the
    component is built, with the JAX registry's error; it never becomes
    an empty value."""
    from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
    from tasksrunner.errors import SecretError as JaxSecretError
    from tasksrunner_torch.errors import SecretError

    path = tmp_path / "store.yaml"
    path.write_text("kind: Component\nmetadata:\n  name: s\nspec:\n  type: state.sqlite\n"
                    "  metadata:\n  - name: password\n    secretKeyRef:\n      name: pw\n"
                    "      key: pw\nauth:\n  secretStore: vault\n")
    (spec,) = load_component_file(path)
    assert (spec.metadata["password"].key, spec.metadata["password"].store) == ("pw", "vault")
    match = "component 's': cannot resolve metadata 'password': secret store 'vault' is not"
    with pytest.raises(JaxSecretError, match=match):
        JaxRegistry(jax_load_component_file(path)).get("s")
    with pytest.raises(SecretError, match=match):
        ComponentRegistry([spec]).get("s")


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
                             ("odd", "bindings.kafka", []))]
    reg = ComponentRegistry(specs, app_id="priority-scorer")
    assert reg.names() == ["bus", "odd", "scores"] and reg.names("state") == ["scores"]
    assert reg.get("scores", block="state") is reg.get("scores")
    with pytest.raises(ComponentNotFound, match="not a pubsub component"):
        reg.get("scores", block="pubsub")
    with pytest.raises(DriverNotFound, match="no driver for component type 'bindings.kafka'"):
        reg.get("odd")
    other = ComponentRegistry(specs, app_id="some-api")
    with pytest.raises(ComponentNotFound, match="not registered for app 'some-api'"):
        other.get("scores")
    assert {"state.sqlite", "state.azure.cosmosdb", "state.postgresql", "state.in-memory",
            "pubsub.sqlite", "pubsub.azure.servicebus", "pubsub.redis",
            "pubsub.in-memory", "bindings.cron", "bindings.azure.storagequeues",
            "bindings.azure.blobstorage", "bindings.twilio.sendgrid"} <= set(registered_types())


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
    """A replica count outside 1..5 and a shard count outside 1..64 are
    refused before any member or shard is built; within them the store
    is built."""
    def spec(**metadata):
        return parse_component({"componentType": "state.sqlite", "metadata": [
            {"name": k, "value": str(v)} for k, v in metadata.items()]}, default_name="s")

    with pytest.raises(ComponentError, match="replicas must be in 1..5, not 6"):
        ComponentRegistry([spec(replicas=6)]).get("s")
    replicated = ComponentRegistry([spec(replicas=2)]).get("s")
    assert type(replicated).__name__ == "ReplicaSetStore" and len(replicated.nodes) == 2
    replicated.close()
    for shards in (0, 65):
        with pytest.raises(ComponentError, match=f"shards must be in 1..64, not {shards}"):
            ComponentRegistry([spec(shards=shards)]).get("s")
    store = ComponentRegistry([spec(shards=2)]).get("s")
    assert type(store).__name__ == "ShardedStateStore" and store.shard_count == 2
    store.close()
