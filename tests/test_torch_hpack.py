"""HPACK (tpfl_torch.communication.hpack) against RFC 7541's own vectors.

- Appendix C, byte for byte: C.1 integers; C.2.1-C.2.4 single fields;
  C.3 / C.4 three requests each, raw and Huffman-coded, with the dynamic
  table's entries and size after each; C.5 / C.6 three responses each at
  a 256-byte table, with eviction.
- The Huffman code: canonical from its lengths, complete (Kraft sum 1),
  EOS 30 ones; the RFC's coded strings re-encoded byte-equal.
- Malformed input raising: Huffman padding over 7 bits, padding that is
  not all ones, an EOS inside a string, a size update above the limit or
  after a field, an index beyond the tables, truncated integers and
  strings.
- Encode -> decode round trips, raw and Huffman-coded.

No JAX: the reference has no HPACK of its own (grpcio carries it), and
``tests/test_torch_grpc_transport.py`` holds the decoder against
grpcio's encoder.
"""

import pytest

from tpfl_torch.communication import hpack


def _h(text):
    return bytes.fromhex("".join(text.split()))


def _fields(*pairs):
    return [(n.encode(), v.encode()) for n, v in pairs]


# --- C.1 integers -------------------------------------------------------------


@pytest.mark.parametrize("value, prefix, wire", [
    (10, 5, "0a"),  # C.1.1
    (1337, 5, "1f9a0a"),  # C.1.2
    (42, 8, "2a"),  # C.1.3
])
def test_c1_integers(value, prefix, wire):
    assert hpack.encode_integer(value, prefix) == _h(wire)
    assert hpack.decode_integer(_h(wire), 0, prefix) == (value, len(_h(wire)))


# --- C.2 single fields -----------------------------------------------------------

C2 = {
    "C.2.1 literal with indexing": (
        "400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
        _fields(("custom-key", "custom-header")), _fields(("custom-key", "custom-header")), 55),
    "C.2.2 literal without indexing": (
        "040c 2f73 616d 706c 652f 7061 7468", _fields((":path", "/sample/path")), [], 0),
    "C.2.3 literal never indexed": (
        "1008 7061 7373 776f 7264 0673 6563 7265 74", _fields(("password", "secret")), [], 0),
    "C.2.4 indexed": ("82", _fields((":method", "GET")), [], 0),
}


@pytest.mark.parametrize("case", sorted(C2))
def test_c2_single_fields(case):
    wire, fields, table, size = C2[case]
    dec = hpack.Decoder()
    assert dec.decode(_h(wire)) == fields
    assert dec.table.entries == table and dec.table.size == size


# --- C.3-C.6 sequences -------------------------------------------------------------

_REQ = [_fields((":method", "GET"), (":scheme", "http"), (":path", "/"),
                (":authority", "www.example.com")),
        _fields((":method", "GET"), (":scheme", "http"), (":path", "/"),
                (":authority", "www.example.com"), ("cache-control", "no-cache")),
        _fields((":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
                (":authority", "www.example.com"), ("custom-key", "custom-value"))]
_REQ_TABLES = [
    (_fields((":authority", "www.example.com")), 57),
    (_fields(("cache-control", "no-cache"), (":authority", "www.example.com")), 110),
    (_fields(("custom-key", "custom-value"), ("cache-control", "no-cache"),
             (":authority", "www.example.com")), 164)]
_DATE1, _DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
_LOC = "https://www.example.com"
_COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
_RESP = [_fields((":status", "302"), ("cache-control", "private"), ("date", _DATE1),
                 ("location", _LOC)),
         _fields((":status", "307"), ("cache-control", "private"), ("date", _DATE1),
                 ("location", _LOC)),
         _fields((":status", "200"), ("cache-control", "private"), ("date", _DATE2),
                 ("location", _LOC), ("content-encoding", "gzip"), ("set-cookie", _COOKIE))]
_RESP_TABLES = [
    (_fields(("location", _LOC), ("date", _DATE1), ("cache-control", "private"),
             (":status", "302")), 222),
    (_fields((":status", "307"), ("location", _LOC), ("date", _DATE1),
             ("cache-control", "private")), 222),
    (_fields(("set-cookie", _COOKIE), ("content-encoding", "gzip"), ("date", _DATE2)), 215)]

SEQUENCES = {
    "C.3 requests": (4096, _REQ, _REQ_TABLES, [
        "8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
        "8286 84be 5808 6e6f 2d63 6163 6865",
        "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65"]),
    "C.4 requests, Huffman": (4096, _REQ, _REQ_TABLES, [
        "8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
        "8286 84be 5886 a8eb 1064 9cbf",
        "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"]),
    "C.5 responses": (256, _RESP, _RESP_TABLES, [
        """4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133
        2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70
        6c65 2e63 6f6d""",
        "4803 3330 37c1 c0bf",
        """88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d
        54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049
        5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e
        3d31"""]),
    "C.6 responses, Huffman": (256, _RESP, _RESP_TABLES, [
        """4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6
        2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3""",
        "4883 640e ffc1 c0bf",
        """88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab
        77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f
        9587 3160 65c0 03ed 4ee5 b106 3d50 07"""]),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_appendix_c_sequences(case):
    limit, fields, tables, wires = SEQUENCES[case]
    dec = hpack.Decoder(limit)
    for i, wire in enumerate(wires):
        assert dec.decode(_h(wire)) == fields[i], f"block {i + 1}"
        entries, size = tables[i]
        assert dec.table.entries == entries and dec.table.size == size, f"table after {i + 1}"
        assert size == sum(hpack.entry_size(n, v) for n, v in entries)


# --- the Huffman code --------------------------------------------------------------


def test_huffman_table_is_canonical_and_complete():
    lengths, codes = hpack.HUFFMAN_LENGTHS, hpack.HUFFMAN_CODES
    assert len(lengths) == 257 and min(lengths) == 5 and max(lengths) == 30
    assert sum(2.0 ** -n for n in lengths) == 1.0  # Kraft: the code space is exactly full
    assert lengths[hpack.EOS] == 30 and codes[hpack.EOS] == 2 ** 30 - 1
    order = sorted(range(257), key=lambda s: (lengths[s], s))
    for a, b in zip(order, order[1:]):  # canonical: each code the last plus one, shifted
        assert codes[b] == (codes[a] + 1) << (lengths[b] - lengths[a])
    # A few codes printed in Appendix B.
    assert (codes[ord("0")], lengths[ord("0")]) == (0x0, 5)
    assert (codes[ord(" ")], lengths[ord(" ")]) == (0x14, 6)
    assert (codes[ord("X")], lengths[ord("X")]) == (0xFC, 8)
    assert (codes[0], lengths[0]) == (0x1FF8, 13)
    assert (codes[255], lengths[255]) == (0x3FFFFEE, 26)


@pytest.mark.parametrize("text, wire", [
    ("www.example.com", "f1e3 c2e5 f23a 6ba0 ab90 f4ff"),
    ("no-cache", "a8eb 1064 9cbf"),
    ("custom-key", "25a8 49e9 5ba9 7d7f"),
    ("custom-value", "25a8 49e9 5bb8 e8b4 bf"),
    ("private", "aec3 771a 4b"),
    ("https://www.example.com", "9d29 ad17 1863 c78f 0b97 c8e9 ae82 ae43 d3"),
])
def test_huffman_strings_of_the_rfc(text, wire):
    assert hpack.huffman_encode(text.encode()) == _h(wire)
    assert hpack.huffman_decode(_h(wire)) == text.encode()


# --- malformed input -----------------------------------------------------------------

_EOS_BYTES = (2 ** 30 - 1).to_bytes(4, "big")  # 30 ones, then 2 padding ones

MALFORMED = {
    "padding over 7 bits": lambda: hpack.huffman_decode(hpack.huffman_encode(b"a") + b"\xff"),
    "padding not ones": lambda: hpack.huffman_decode(b"\x00"),  # "0" then 0-padding...
    "eos in string": lambda: hpack.huffman_decode(_EOS_BYTES),
    "size update above limit": lambda: hpack.Decoder(256).decode(b"\x3f\xe2\x01"),  # 257
    "size update after a field": lambda: hpack.Decoder().decode(b"\x82\x20"),
    "index beyond the tables": lambda: hpack.Decoder().decode(b"\xbe"),  # 62, empty table
    "index zero": lambda: hpack.Decoder().decode(b"\x80"),
    "truncated integer": lambda: hpack.Decoder().decode(b"\xff"),
    "truncated string": lambda: hpack.Decoder().decode(b"\x40\x05ab"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_raises(case):
    with pytest.raises(hpack.HPACKError):
        MALFORMED[case]()


# --- round trips --------------------------------------------------------------------

ROUND_TRIPS = {
    "grpc request": [(":method", "POST"), (":scheme", "http"),
                     (":path", "/tpfl.NodeServices/SendStream"), (":authority", "127.0.0.1:5000"),
                     ("te", "trailers"), ("content-type", "application/grpc"),
                     ("grpc-timeout", "2500m")],
    "grpc trailers": [("grpc-status", "13"), ("grpc-message", "bad%20thing%0A")],
    "every printable byte": [("x-ascii", "".join(map(chr, range(0x20, 0x7F))))],
    "every byte": [("x-bin", "".join(map(chr, range(256))))],
    "empty value": [("x-empty", ""), ("accept", "")],
    "long value": [("x-long", "z" * 5000)],
}


@pytest.mark.parametrize("huffman", [False, True])
@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_encode_decode_round_trip(case, huffman):
    """The Encoder's blocks (raw literals), and each field as a literal
    with incremental indexing whose strings are Huffman-coded."""
    fields = [(n.encode("latin-1"), v.encode("latin-1")) for n, v in ROUND_TRIPS[case]]
    dec = hpack.Decoder()
    if huffman:
        block = b"".join(b"\x40" + hpack.encode_string(n, True) + hpack.encode_string(v, True)
                         for n, v in fields)
        assert dec.decode(block) == fields
        assert dec.table.entries == [f for f in reversed(fields)
                                     if hpack.entry_size(*f) <= 4096][:len(dec.table.entries)]
        return
    enc = hpack.Encoder()
    for _ in range(2):  # the first block also carries the size update to 0
        assert dec.decode(enc.encode(fields)) == fields
        assert dec.table.entries == []
    enc.table_size_changed()
    assert enc.encode([]) == b"\x20"
