"""The instruction compiler must reproduce the reference's `--compile`
output byte for byte (test/BDGGG/valid/compile_*.out) when invoked with the
reference's exact argv."""

import os

import pytest

from pheniqs_tpu.cli.interface import Interface
from pheniqs_tpu.config.compiler import InstructionCompiler, write_compiled_instruction
from pheniqs_tpu.config.jsonkit import dtoa


def compile_config(reference_root, config, extra=()):
    cwd = os.getcwd()
    os.chdir(reference_root)
    try:
        argv = [
            "./pheniqs",
            "mux",
            "--config",
            config,
            "--precision",
            "15",
            *extra,
        ]
        interface = Interface(argv)
        operation = interface.operation()
        compiler = InstructionCompiler(operation)
        compiler.assemble()
        ontology = compiler.compile()
        return write_compiled_instruction(ontology, 15)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", ["annotated", "interleave"])
def test_compile_matches_golden(reference_root, name):
    got = compile_config(
        reference_root, f"test/BDGGG/BDGGG_{name}.json", ("--compile",)
    )
    golden = open(
        os.path.join(reference_root, f"test/BDGGG/valid/compile_{name}.out")
    ).read()
    assert got + "\n" == golden


def test_dtoa_rapidjson_compatible():
    cases = [
        (0.18 * 0.985, "0.177299999999999"),
        (0.17 * 0.985, "0.16745"),
        (4.0**-8, "0.000015258789062"),
        (1.0, "1.0"),
        (244 / 248, "0.983870967741935"),
        (1e30, "1e30"),
        (1.5e30, "1.5e30"),
        (1e-30, "0.0"),
        (0.0, "0.0"),
        (100.0, "100.0"),
    ]
    for value, expected in cases:
        assert dtoa(value, 15) == expected, value


def test_inheritance_cycle_detection():
    from pheniqs_tpu.config.compiler import apply_repository_inheritance
    from pheniqs_tpu.errors import CommandLineError

    with pytest.raises(CommandLineError):
        apply_repository_inheritance(
            {"decoder": {"a": {"base": "b"}, "b": {"base": "a"}}}
        )


# ---------------------------------------------------------------------------
# table-driven edge coverage for the compiler internals:
# inheritance cycles, projection precedence, undetermined synthesis corners,
# PU/ID inference, concentration normalization, barcode/transform validation.
# Reference anchors: transcode.cpp:328-443 (inheritance), 736-763 (default
# knit), 764-1039 (decoder/codec compilation).
# ---------------------------------------------------------------------------

from pheniqs_tpu.errors import CommandLineError, ConfigurationError  # noqa: E402


def make_compiler(projection=None, input_cardinality=2):
    compiler = InstructionCompiler({"projection": projection or {}})
    compiler.ontology = {"input segment cardinality": input_cardinality}
    return compiler


INHERITANCE_FAILURES = [
    # (repository, reason)
    ({"a": {"base": "a"}}, "self reference"),
    ({"a": {"base": "b"}, "b": {"base": "a"}}, "2-cycle"),
    (
        {"a": {"base": "b"}, "b": {"base": "c"}, "c": {"base": "a"}},
        "3-cycle",
    ),
    ({"a": {"base": "ghost"}}, "unknown parent"),
]


@pytest.mark.parametrize(
    "repository, reason", INHERITANCE_FAILURES, ids=lambda v: str(v)[:40]
)
def test_repository_inheritance_failures(repository, reason):
    from pheniqs_tpu.config.compiler import apply_repository_inheritance

    with pytest.raises(CommandLineError):
        apply_repository_inheritance({"decoder": repository})


def test_repository_inheritance_chain_precedence():
    """A three-deep chain resolves in depth order and the child always
    wins over the parent, the parent over the grandparent."""
    from pheniqs_tpu.config.compiler import apply_repository_inheritance

    container = {
        "decoder": {
            "grand": {"noise": 0.01, "algorithm": "pamld", "CN": "core"},
            "parent": {"base": "grand", "noise": 0.02, "SM": "sample"},
            "child": {"base": "parent", "noise": 0.03},
        }
    }
    apply_repository_inheritance(container)
    child = container["decoder"]["child"]
    assert child["noise"] == 0.03  # own value wins
    assert child["SM"] == "sample"  # parent's addition survives
    assert child["algorithm"] == "pamld"  # grandparent's survives
    assert child["CN"] == "core"
    assert "base" not in child  # consumed, not emitted


def test_decoder_inheritance_unknown_base_is_typed():
    from pheniqs_tpu.config.compiler import apply_inheritance

    with pytest.raises(ConfigurationError) as err:
        apply_inheritance(
            {"decoder": {"known": {}}, "sample": {"base": "ghost"}}
        )
    assert "sample decoder" in err.value.message


def test_list_topic_inheritance_names_the_index():
    from pheniqs_tpu.config.compiler import apply_inheritance

    with pytest.raises(ConfigurationError) as err:
        apply_inheritance(
            {
                "decoder": {"known": {}},
                "molecular": [{"base": "known"}, {"base": "ghost"}],
            }
        )
    assert "molecular decoder at 1" in err.value.message


def _sample_decoder(codec=None, **extra):
    value = {
        "transform": {"token": ["0::8"]},
        "codec": codec
        if codec is not None
        else {"@A": {"barcode": ["AAAAAAAA"]}, "@B": {"barcode": ["CCCCCCCC"]}},
    }
    value.update(extra)
    return value


def compile_sample(compiler, decoder):
    compiler.ontology["sample"] = decoder
    compiler.compile_topic("sample")
    return compiler.ontology["sample"]


def test_projection_precedence_explicit_beats_projection():
    """decoder-level projection supplies defaults; explicit decoder and
    barcode values always win; projection defaults fill the gaps."""
    projection = {
        "sample:decoder": {"algorithm": "pamld", "confidence threshold": 0.95},
        "sample:barcode": {"LB": "default-library"},
    }
    compiler = make_compiler(projection)
    decoder = _sample_decoder(
        codec={
            "@A": {"barcode": ["AAAAAAAA"], "LB": "explicit-library"},
            "@B": {"barcode": ["CCCCCCCC"]},
        },
        algorithm="mdd",
    )
    compiled = compile_sample(compiler, decoder)
    assert compiled["algorithm"] == "mdd"  # explicit beats projection
    assert compiled["confidence threshold"] == 0.95  # projection fills
    codec = compiled["codec"]
    assert codec["@A"]["LB"] == "explicit-library"
    assert codec["@B"]["LB"] == "default-library"


def test_projection_projects_from_decoder_ontology():
    """`sample:barcode` keys present on the decoder project the decoder's
    own value into every barcode (reference json.cpp:804-833)."""
    projection = {"sample:barcode": {"flowcell id": None}}
    compiler = make_compiler(projection)
    compiled = compile_sample(
        compiler, _sample_decoder(**{"flowcell id": "HXXT5"})
    )
    assert compiled["codec"]["@A"]["flowcell id"] == "HXXT5"
    # and PU inference picked it up as the prefix
    assert compiled["codec"]["@A"]["PU"] == "HXXT5:AAAAAAAA"


UNDETERMINED_CASES = [
    # (token array, expected synthetic barcode list)
    (["0::8"], ["========"]),
    (["0::8", "1::6"], ["========", "======"]),  # multi-segment
    (["0:2:5", "0:6:10"], ["===", "===="]),  # offset windows
]


@pytest.mark.parametrize("token, expected", UNDETERMINED_CASES)
def test_undetermined_synthesis(token, expected):
    codec = {
        "@A": {"barcode": ["A" * len(s) for s in expected]},
        "@B": {"barcode": ["C" * len(s) for s in expected]},
    }
    compiler = make_compiler()
    compiled = compile_sample(
        compiler, {"transform": {"token": token}, "codec": codec, "noise": 0.05}
    )
    undetermined = compiled["undetermined"]
    assert undetermined["barcode"] == expected
    assert undetermined["index"] == 0  # always barcode 0
    assert undetermined["segment cardinality"] == len(expected)
    assert undetermined["concentration"] == pytest.approx(0.05)  # = noise
    assert undetermined["PU"] == "undetermined"


def test_undetermined_explicit_output_survives_merge():
    compiler = make_compiler()
    decoder = _sample_decoder(undetermined={"output": ["undet.fastq"]})
    compiled = compile_sample(compiler, decoder)
    assert compiled["undetermined"]["output"] == ["undet.fastq"]
    assert compiled["undetermined"]["barcode"] == ["========"]


PU_CASES = [
    # (container, undetermined_tag, expected PU)
    ({"PU": "explicit"}, False, "explicit"),
    ({"barcode": ["ACGT", "TTTT"]}, False, "ACGTTTTT"),
    ({"barcode": ["ACGT"], "flowcell id": "FC1"}, False, "FC1:ACGT"),
    (
        {
            "barcode": ["ACGT"],
            "flowcell id": "FC1",
            "flowcell lane number": 3,
        },
        False,
        "FC1:3:ACGT",
    ),
    # lane without flowcell id contributes nothing (reference order)
    ({"barcode": ["ACGT"], "flowcell lane number": 3}, False, "ACGT"),
    ({}, True, "undetermined"),
    ({"flowcell id": "FC1"}, True, "FC1:undetermined"),
    ({}, False, None),  # no barcode, no PU
]


@pytest.mark.parametrize(
    "container, undetermined_tag, expected", PU_CASES, ids=lambda v: str(v)[:40]
)
def test_infer_PU(container, undetermined_tag, expected):
    compiler = make_compiler()
    assert compiler.infer_PU(dict(container), undetermined_tag) == expected


def test_infer_ID_prefers_explicit_then_PU():
    compiler = make_compiler()
    assert compiler.infer_ID({"ID": "mine", "PU": "pu"}) == "mine"
    container = {"PU": "pu"}
    assert compiler.infer_ID(container) == "pu"
    assert container["ID"] == "pu"
    assert compiler.infer_ID({}) is None


def test_duplicate_inferred_ID_raises():
    compiler = make_compiler()
    codec = {
        "@A": {"barcode": ["AAAAAAAA"]},
        "@B": {"barcode": ["CCCCCCCC"], "ID": "AAAAAAAA"},
    }
    with pytest.raises(ConfigurationError) as err:
        compile_sample(compiler, _sample_decoder(codec=codec))
    assert "duplicate" in err.value.message


def test_concentration_normalization():
    """(1 - noise) is distributed over the codec proportional to the
    declared concentrations (reference transcode.cpp:943-1008)."""
    compiler = make_compiler()
    codec = {
        "@A": {"barcode": ["AAAAAAAA"], "concentration": 3.0},
        "@B": {"barcode": ["CCCCCCCC"], "concentration": 1.0},
    }
    compiled = compile_sample(
        compiler, _sample_decoder(codec=codec, noise=0.2)
    )
    assert compiled["codec"]["@A"]["concentration"] == pytest.approx(0.6)
    assert compiled["codec"]["@B"]["concentration"] == pytest.approx(0.2)
    assert compiled["undetermined"]["concentration"] == pytest.approx(0.2)
    assert compiled["barcode cardinality"] == 3  # undetermined + 2


CONCENTRATION_FAILURES = [
    ({"@A": {"barcode": ["AAAAAAAA"], "concentration": -1.0}}, "negative"),
    ({"@A": {"barcode": ["AAAAAAAA"], "concentration": 0.0}}, "zero total"),
]


@pytest.mark.parametrize(
    "codec, reason", CONCENTRATION_FAILURES, ids=lambda v: str(v)[:40]
)
def test_concentration_failures(codec, reason):
    compiler = make_compiler()
    with pytest.raises(ConfigurationError):
        compile_sample(compiler, _sample_decoder(codec=codec))


BARCODE_FAILURES = [
    # wrong segment count: 2 segments declared, transform has 1
    ({"@A": {"barcode": ["AAAA", "CCCC"]}}, "segment count"),
    # wrong length: token is 8 wide
    ({"@A": {"barcode": ["AAAA"]}}, "segment length"),
    # duplicate sequence across keys
    (
        {
            "@A": {"barcode": ["AAAAAAAA"]},
            "@B": {"barcode": ["AAAAAAAA"]},
        },
        "duplicate sequence",
    ),
]


@pytest.mark.parametrize(
    "codec, reason", BARCODE_FAILURES, ids=lambda v: str(v)[:40]
)
def test_barcode_validation_failures(codec, reason):
    compiler = make_compiler()
    with pytest.raises(ConfigurationError):
        compile_sample(compiler, _sample_decoder(codec=codec))


def test_random_barcode_probability_lower_bound():
    compiler = make_compiler()
    decoder = _sample_decoder(**{"random barcode probability": 4.0**-9})
    with pytest.raises(ConfigurationError):
        compile_sample(compiler, decoder)
    # default synthesizes the 4^-n lower bound
    compiler = make_compiler()
    compiled = compile_sample(compiler, _sample_decoder())
    assert compiled["random barcode probability"] == pytest.approx(4.0**-8)


TRANSFORM_FAILURES = [
    ({"transform": {}}, "missing token"),
    ({"transform": {"token": "0::8"}}, "token not an array"),
    ({"transform": {"token": ["5::8"]}}, "segment out of range"),
    ({"transform": {"token": ["0:4:4"]}}, "empty token"),
    ({"transform": {"token": ["0::"]}}, "unbounded token"),
]


@pytest.mark.parametrize(
    "value, reason", TRANSFORM_FAILURES, ids=lambda v: str(v)[:40]
)
def test_transform_validation_failures(value, reason):
    compiler = make_compiler()
    value = dict(value)
    value["codec"] = {"@A": {"barcode": ["AAAAAAAA"]}}
    with pytest.raises((ConfigurationError, CommandLineError)):
        compile_sample(compiler, value)


def test_default_knit_synthesis():
    compiler = make_compiler()
    value = {
        "transform": {"token": ["0::4", "1::4"]},
        "codec": {"@A": {"barcode": ["AAAA", "CCCC"]}},
    }
    compiled = compile_sample(compiler, value)
    assert compiled["transform"]["knit"] == ["0", "1"]
    assert compiled["barcode length"] == [4, 4]
    assert compiled["nucleotide cardinality"] == 8


# ---------------------------------------------------------------------------
# multiplexing-decoder election + output compilation edges. Reference
# anchors: transcode.cpp:1087-1223 (election:
# explicit flag > has-output > sample), 1261-1445 (channel URL
# canonicalization, TC emission, feed resolution).
# ---------------------------------------------------------------------------


def _election_compiler(ontology):
    compiler = InstructionCompiler({"projection": {}})
    compiler.ontology = ontology
    return compiler


def _dec(**extra):
    value = {"codec": {"@A": {"barcode": ["AAAA"]}}}
    value.update(extra)
    return value


def test_election_explicit_flag_beats_output():
    """A cellular decoder carrying the explicit flag wins even when the
    sample decoder mentions output."""
    sample = _dec(output=["x.sam"])
    cellular = _dec(**{"multiplexing classifier": True})
    compiler = _election_compiler(
        {"sample": sample, "cellular": [cellular]}
    )
    assert compiler.find_multiplexing_decoder() is cellular


def test_election_two_explicit_flags_fail():
    from pheniqs_tpu.errors import ConfigurationError

    sample = _dec(**{"multiplexing classifier": True})
    cellular = _dec(**{"multiplexing classifier": True})
    compiler = _election_compiler(
        {"sample": sample, "cellular": [cellular]}
    )
    with pytest.raises(ConfigurationError):
        compiler.find_multiplexing_decoder()


@pytest.mark.parametrize(
    "shape",
    ["decoder", "undetermined", "codec"],
    ids=["decoder-level", "undetermined-level", "barcode-level"],
)
def test_election_output_mention_elects(shape):
    """`output` at any level of a decoder (decoder, undetermined, or a
    codec barcode) makes it the multiplexing classifier, and the flag is
    written back."""
    cellular = _dec()
    if shape == "decoder":
        cellular["output"] = ["x.sam"]
    elif shape == "undetermined":
        cellular["undetermined"] = {"output": ["x.sam"]}
    else:
        cellular["codec"]["@A"]["output"] = ["x.sam"]
    sample = _dec()
    compiler = _election_compiler(
        {"sample": sample, "cellular": [cellular]}
    )
    elected = compiler.find_multiplexing_decoder()
    assert elected is cellular
    assert elected["multiplexing classifier"] is True


def test_election_defaults_to_sample():
    sample = _dec()
    cellular = _dec()
    compiler = _election_compiler(
        {"sample": sample, "cellular": [cellular]}
    )
    elected = compiler.find_multiplexing_decoder()
    assert elected is sample
    assert elected["multiplexing classifier"] is True


def test_election_two_output_mentions_fail():
    from pheniqs_tpu.errors import ConfigurationError

    sample = _dec(output=["x.sam"])
    cellular = _dec(output=["y.sam"])
    compiler = _election_compiler(
        {"sample": sample, "cellular": [cellular]}
    )
    with pytest.raises(ConfigurationError):
        compiler.find_multiplexing_decoder()


def _output_compiler(decoder, input_cardinality=1, **ontology_extra):
    ontology = {
        "input segment cardinality": input_cardinality,
        "sample": decoder,
    }
    ontology.update(ontology_extra)
    return _election_compiler(ontology)


def test_output_channel_url_dedup_and_tc():
    """Two channels naming the same output path share ONE feed proxy
    (canonical URL, query overrides merged) and every channel gets
    TC = output segment cardinality."""
    decoder = {
        "codec": {
            "@A": {"barcode": ["AAAA"], "index": 1,
                   "output": ["shared.bam"]},
            "@B": {"barcode": ["CCCC"], "index": 2,
                   "output": ["shared.bam?level=3"]},
        },
        "undetermined": {"index": 0, "output": ["undet.sam"]},
    }
    compiler = _output_compiler(decoder)
    compiler.ontology["feed"] = {}
    compiler.compile_output()
    feeds = compiler.ontology["feed"]["output feed"]
    paths = [p["url"] for p in feeds]
    assert len([p for p in paths if "shared.bam" in p]) == 1
    shared = next(p for p in feeds if "shared.bam" in p["url"])
    # the second channel's query override (compression level) merged
    # into the canonical URL both channels now reference
    assert shared["resolution"] == 1
    for element in [decoder["undetermined"], *decoder["codec"].values()]:
        assert element["TC"] == 1
    # both codec channels reference the SAME canonical encoded URL
    a, b = (decoder["codec"][key]["output"][0] for key in ("@A", "@B"))
    assert a == b


def test_output_stdin_rejected():
    from pheniqs_tpu.errors import ConfigurationError

    decoder = {
        "codec": {"@A": {"barcode": ["AAAA"], "index": 1,
                          "output": ["/dev/stdin"]}},
    }
    compiler = _output_compiler(decoder)
    compiler.ontology["feed"] = {}
    with pytest.raises(ConfigurationError):
        compiler.compile_output()


def test_output_inconsistent_resolution_rejected():
    from pheniqs_tpu.errors import ConfigurationError

    decoder = {
        "codec": {
            "@A": {"barcode": ["AAAA"], "index": 1,
                   "output": ["x.sam", "x.sam"]},
            "@B": {"barcode": ["CCCC"], "index": 2,
                   "output": ["x.sam", "y.sam"]},
        },
    }
    compiler = _output_compiler(decoder, input_cardinality=2)
    compiler.ontology["feed"] = {}
    with pytest.raises(ConfigurationError):
        compiler.compile_output()


def test_output_single_url_padded_to_cardinality():
    """A channel naming one URL for a 2-segment template gets the URL
    repeated (interleaved output), resolution 2."""
    decoder = {
        "codec": {"@A": {"barcode": ["AAAA"], "index": 1,
                          "output": ["x.sam"]}},
    }
    compiler = _output_compiler(decoder, input_cardinality=2)
    compiler.ontology["feed"] = {}
    compiler.compile_output()
    assert len(decoder["codec"]["@A"]["output"]) == 2
    feeds = compiler.ontology["feed"]["output feed"]
    assert feeds[0]["resolution"] == 2
