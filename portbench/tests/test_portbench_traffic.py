"""The traffic generator: every mix is made from the seed, at the size
asked for, with the same layout for every seed."""

import json
import pathlib

import numpy as np
import pytest

from portbench.lib import generate

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("nbytes", [0, 1, 1000, 70001])
def test_size_and_determinism(name, nbytes):
    a = generate.generate(mix(name), nbytes, 2**31 + 11)
    assert len(a) == nbytes
    assert a == generate.generate(mix(name), nbytes, 2**31 + 11)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ(name):
    assert (generate.generate(mix(name), 4096, 1)
            != generate.generate(mix(name), 4096, 2))


def test_records_prefix_of_a_longer_pool():
    assert generate.generate(mix("records"), 3000, 9) == \
        generate.generate(mix("records"), 9000, 9)[:3000]


def test_records_layout_is_the_same_for_every_seed():
    """The layout seed fixes each word's length and place and the
    separators; the run's seed makes the words' bytes."""
    a = np.frombuffer(generate.generate(mix("records"), 1 << 18, 3),
                      np.uint8)
    b = np.frombuffer(generate.generate(mix("records"), 1 << 18, 2**33 + 1),
                      np.uint8)
    assert np.array_equal(a >= 0xF0, b >= 0xF0)
    assert np.array_equal(a[a >= 0xF0], b[b >= 0xF0])
    assert (a != b).mean() > 0.5


def test_text_layout_is_the_same_for_every_seed():
    """Every seed's text has the same words in the same places (the same
    spaces, line breaks, capitals and marks), spelt differently."""
    p = mix("text")
    a = generate.generate(p, 1 << 17, 3)
    b = generate.generate(p, 1 << 17, 2**33 + 1)

    def layout(t):
        return bytes(c if not chr(c).isalpha() else
                     (65 if chr(c).isupper() else 97) for c in t)

    assert layout(a) == layout(b)
    assert a != b


def test_text_lines_and_sentences():
    p = mix("text")
    text = generate.generate(p, 200000, 77).decode("ascii")
    lines = text.split("\n")
    col = p["line_width"]
    for line in lines[:-1]:
        # broken at the first space past the column
        assert len(line) >= col and " " not in line[col:]
    words = text.split()
    assert all(p["word_letters"][0] <= len(w.strip(p["enders"]))
               <= p["word_letters"][1] for w in words)
    marks = sum(w[-1] in p["enders"] for w in words)
    lo, hi = p["sentence_words"]
    assert len(words) / hi <= marks <= len(words) / lo + 1


def test_unknown_recipe():
    with pytest.raises(ValueError):
        generate.generate({"generator": "nope"}, 10, 1)
    with pytest.raises(ValueError):
        generate.generate({"generator": "../lib/check"}, 10, 1)


def test_pool_is_the_seeds_data():
    """A run's waves are its seed's data, cut in order: each block's place
    is its lane for every seed."""
    p = mix("records")
    a = generate.pool(p, 2, 4, 1000, 2**31 + 9)
    assert [len(w) for w in a] == [4, 4]
    data = generate.generate(p, 8000, 2**31 + 9)
    assert b"".join(b"".join(w) for w in a) == data


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_its_layout_seed_and_recipe(name):
    assert isinstance(mix(name)["layout_seed"], int)
    assert (TRAFFIC.parent / "recipes" / f"{mix(name)['generator']}.py"
            ).is_file()


def test_added_recipe_is_found_by_name(tmp_path):
    """A recipe added as a file of its own, and nothing else."""
    (tmp_path / "ramp.py").write_text(
        "def make(p, nbytes, seed):\n"
        "    return bytes((seed + i * p['step']) % 256 "
        "for i in range(nbytes))\n")
    p = {"generator": "ramp", "step": 3}
    assert generate.generate(p, 4, 1, tmp_path) == bytes([1, 4, 7, 10])
    assert generate.pool(p, 1, 2, 2, 1, tmp_path) == [[bytes([1, 4]),
                                                       bytes([7, 10])]]
