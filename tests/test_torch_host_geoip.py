"""The port's GeoIP mmdb decoder (`pingoo_tpu_torch.host.geoip`) on every
case of test_geoip.py, held to the JAX package's: the same database
bytes from `build_mmdb`, the same records and misses."""

import pytest

from pingoo_tpu.host import geoip as ref_geoip
from pingoo_tpu_torch.host.geoip import (
    AddressNotFound,
    GeoipDB,
    GeoipRecord,
    MmdbReader,
    build_mmdb,
    parse_asn,
    record_from_raw,
)

ENTRIES = {
    "8.8.8.0/24": {"asn": "AS15169", "country": "US"},
    "203.0.113.0/24": {"asn": 64500, "country": "FR"},
    "10.0.0.0/8": {"asn": "AS0", "country": "XX"},
}

PROBES = ("8.8.8.8", "8.8.8.255", "203.0.113.77", "10.200.1.1", "9.9.9.9",
          "2001:db8::1", "127.0.0.1", "224.0.0.1", "::1", "8.8.9.1")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    raw = build_mmdb(ENTRIES)
    path = tmp_path_factory.mktemp("geoip") / "geoip.mmdb"
    path.write_bytes(raw)
    db = GeoipDB.load(paths=(str(path),))
    assert db is not None
    return db


def lookup(db, ip):
    try:
        rec = db.lookup(ip)
        return (rec.asn, rec.country)
    except Exception as exc:  # AddressNotFound of either package
        return type(exc).__name__


def test_same_database_and_records_as_the_jax_package(db, tmp_path):
    raw = build_mmdb(ENTRIES)
    assert raw == ref_geoip.build_mmdb(ENTRIES)
    path = tmp_path / "geoip.mmdb"
    path.write_bytes(raw)
    ref_db = ref_geoip.GeoipDB.load(paths=(str(path),))
    assert [lookup(db, ip) for ip in PROBES] \
        == [lookup(ref_db, ip) for ip in PROBES]
    assert MmdbReader(raw).metadata == ref_geoip.MmdbReader(raw).metadata


class TestDecoder:
    def test_lookup_hits(self, db):
        assert db.lookup("8.8.8.8") == GeoipRecord(15169, "US")
        assert db.lookup("8.8.8.255") == GeoipRecord(15169, "US")
        assert db.lookup("203.0.113.77") == GeoipRecord(64500, "FR")
        assert db.lookup("10.200.1.1") == GeoipRecord(0, "XX")

    def test_miss_raises(self, db):
        with pytest.raises(AddressNotFound):
            db.lookup("9.9.9.9")
        with pytest.raises(AddressNotFound):
            db.lookup("2001:db8::1")

    def test_loopback_multicast_short_circuit(self, db):
        # geoip.rs:74-77
        with pytest.raises(AddressNotFound):
            db.lookup("127.0.0.1")
        with pytest.raises(AddressNotFound):
            db.lookup("224.0.0.1")

    def test_cache(self, db):
        r1 = db.lookup("8.8.8.8")
        r2 = db.lookup("8.8.8.8")
        assert r1 == r2

    def test_metadata(self, db):
        assert db.reader.metadata["database_type"] == "pingoo-tpu-test"

    def test_zst_loading(self, tmp_path):
        import zstandard

        raw = build_mmdb(ENTRIES)
        path = tmp_path / "geoip.mmdb.zst"
        path.write_bytes(zstandard.ZstdCompressor().compress(raw))
        db = GeoipDB.load(paths=(str(path),))
        assert db.lookup("8.8.8.8").asn == 15169

    def test_missing_db_disables(self, tmp_path):
        assert GeoipDB.load(paths=(str(tmp_path / "none.mmdb"),)) is None


class TestSchemas:
    def test_parse_asn(self):
        # serde_utils.rs:1-9: "AS123" -> 123
        assert parse_asn("AS15169") == 15169
        assert parse_asn("as15169") == 15169
        assert parse_asn(15169) == 15169
        assert parse_asn("junk") == 0
        for v in ("AS15169", "as15169", 15169, "junk", "AS", None):
            assert parse_asn(v) == ref_geoip.parse_asn(v)

    def test_geolite2_schema(self):
        raw = {"country": {"iso_code": "de"}, "autonomous_system_number": 3320}
        rec = record_from_raw(raw)
        assert rec == GeoipRecord(3320, "DE")
        ref = ref_geoip.record_from_raw(raw)
        assert (rec.asn, rec.country) == (ref.asn, ref.country)

    def test_flat_schema(self):
        assert record_from_raw({"asn": "AS1", "country": "jp"}) == GeoipRecord(1, "JP")

    def test_bad_country_falls_back(self):
        assert record_from_raw({"country": "LONG"}).country == "XX"
        assert ref_geoip.record_from_raw({"country": "LONG"}).country == "XX"
