"""GPS LNAV navigation-message construction: subframes, pages, parity.

Host-side integer bit-packing, executed once per 30 s per channel. Mirrors
reference gps.c:617-884 (eph2sbf page buffer incl. almanac/iono/health
pages), gps.c:1008-1072 (computeChecksum with non-information-bit solving),
and gps.c:2066-2140 (generateNavMsg frame serializer with TOW/WN insertion,
parity chaining and page cycling). An independent parity checker
(reference gps.c:907-1001) lives in tests as the verification oracle.

Output of the serializer is the 60-word ``dwrd`` buffer; the synth kernels
consume it as a ``uint32[channels, 60]`` array.
"""

from __future__ import annotations


import numpy as np

from .almanac import Almanac
from .atmosphere import IonoUtc
from .constants import (
    EMPTY_WORD,
    MAX_SAT,
    c_round as _c_round,
    N_DWRD,
    N_DWRD_SBF,
    N_SBF,
    N_SBF_PAGE,
    PARITY_MASKS,
    PI,
    POW2_12,
    POW2_M5,
    POW2_M11,
    POW2_M19,
    POW2_M20,
    POW2_M21,
    POW2_M23,
    POW2_M24,
    POW2_M27,
    POW2_M29,
    POW2_M30,
    POW2_M31,
    POW2_M33,
    POW2_M38,
    POW2_M43,
    POW2_M50,
    POW2_M55,
    SBF4_SVID,
    SBF5_SVID,
)
from .gpstime import GpsTime
from .orbits import EphemerisSet

_U32 = 0xFFFFFFFF


def _trunc(x: float) -> int:
    """C (long) cast: truncate toward zero."""
    return int(x)


def count_bits(v: int) -> int:
    return bin(v & _U32).count("1")


def compute_checksum(source: int, nib: bool) -> int:
    """IS-GPS-200 word parity (reference gps.c:1008-1072).

    source bits: <D29* D30* d1..d24 000000>; returns the completed 30-bit
    word with D29*/D30* preserved in the top bits. When ``nib`` is set the
    non-information bits 23/24 are solved so D29/D30 come out zero (words 2
    and 10 of each subframe).
    """
    d = source & 0x3FFFFFC0
    d29 = (source >> 31) & 0x1
    d30 = (source >> 30) & 0x1

    if nib:
        if (d30 + count_bits(PARITY_MASKS[4] & d)) % 2:
            d ^= 0x1 << 6
        if (d29 + count_bits(PARITY_MASKS[5] & d)) % 2:
            d ^= 0x1 << 7

    D = d
    if d30:
        D ^= 0x3FFFFFC0

    D |= ((d29 + count_bits(PARITY_MASKS[0] & d)) % 2) << 5
    D |= ((d30 + count_bits(PARITY_MASKS[1] & d)) % 2) << 4
    D |= ((d29 + count_bits(PARITY_MASKS[2] & d)) % 2) << 3
    D |= ((d30 + count_bits(PARITY_MASKS[3] & d)) % 2) << 2
    D |= ((d30 + count_bits(PARITY_MASKS[4] & d)) % 2) << 1
    D |= (d29 + count_bits(PARITY_MASKS[5] & d)) % 2

    D &= 0x3FFFFFFF
    D |= source & 0xC0000000
    return D


def eph2sbf(
    eph: EphemerisSet, sv: int, ionoutc: IonoUtc, alm: Almanac
) -> np.ndarray:
    """Build the 53-page × 10-word subframe buffer for one SV.

    Reference gps.c:617-884. Returns uint32[53, 10] (30-bit payload words
    without parity; parity added at serialization time).
    """
    wn = 0  # transmission week is OR-ed in at serialization (gps.c:659-661)
    toe = _trunc(eph.toe_sec[sv] / 16.0)
    toc = _trunc(eph.toc_sec[sv] / 16.0)
    iode = int(eph.iode[sv])
    iodc = int(eph.iodc[sv])
    deltan = _trunc(eph.deltan[sv] / POW2_M43 / PI)
    cuc = _trunc(eph.cuc[sv] / POW2_M29)
    cus = _trunc(eph.cus[sv] / POW2_M29)
    cic = _trunc(eph.cic[sv] / POW2_M29)
    cis = _trunc(eph.cis[sv] / POW2_M29)
    crc = _trunc(eph.crc[sv] / POW2_M5)
    crs = _trunc(eph.crs[sv] / POW2_M5)
    ecc = _trunc(eph.ecc[sv] / POW2_M33)
    sqrta = _trunc(eph.sqrta[sv] / POW2_M19)
    m0 = _trunc(eph.m0[sv] / POW2_M31 / PI)
    omega0 = _trunc(eph.omg0[sv] / POW2_M31 / PI)
    inc0 = _trunc(eph.inc0[sv] / POW2_M31 / PI)
    aop = _trunc(eph.aop[sv] / POW2_M31 / PI)
    omegadot = _trunc(eph.omgdot[sv] / POW2_M43 / PI)
    idot = _trunc(eph.idot[sv] / POW2_M43 / PI)
    af0 = _trunc(eph.af0[sv] / POW2_M31)
    af1 = _trunc(eph.af1[sv] / POW2_M43)
    af2 = _trunc(eph.af2[sv] / POW2_M55)
    tgd = _trunc(eph.tgd[sv] / POW2_M31)

    alpha0 = _c_round(ionoutc.alpha0 / POW2_M30)
    alpha1 = _c_round(ionoutc.alpha1 / POW2_M27)
    alpha2 = _c_round(ionoutc.alpha2 / POW2_M24)
    alpha3 = _c_round(ionoutc.alpha3 / POW2_M24)
    beta0 = _c_round(ionoutc.beta0 / 2048.0)
    beta1 = _c_round(ionoutc.beta1 / 16384.0)
    beta2 = _c_round(ionoutc.beta2 / 65536.0)
    beta3 = _c_round(ionoutc.beta3 / 65536.0)
    A0 = _c_round(ionoutc.A0 / POW2_M30)
    A1 = _c_round(ionoutc.A1 / POW2_M50)
    dtls = int(ionoutc.dtls)
    tot = _trunc(ionoutc.tot / 4096)
    wnt = int(ionoutc.wnt) % 256
    # Fixed scheduled leap second: 2016/12/31 (gps.c:700-704).
    wnlsf = 1929 % 256
    dn = 7
    dtlsf = 18

    ura = 0
    data_id = 1

    sbf = np.zeros((N_SBF_PAGE, N_DWRD_SBF), dtype=np.uint64)

    def W(*vals: int) -> int:
        out = 0
        for v in vals:
            out |= v
        return out & _U32

    # Subframe 1 (gps.c:707-716)
    sbf[0] = [
        0x8B0000 << 6,
        0x1 << 8,
        W(((wn & 0x3FF) << 20), (ura << 14), (((iodc >> 8) & 0x3) << 6)),
        0,
        0,
        0,
        (tgd & 0xFF) << 6,
        W(((iodc & 0xFF) << 22), ((toc & 0xFFFF) << 6)),
        W(((af2 & 0xFF) << 22), ((af1 & 0xFFFF) << 6)),
        (af0 & 0x3FFFFF) << 8,
    ]

    # Subframe 2 (gps.c:719-728)
    sbf[1] = [
        0x8B0000 << 6,
        0x2 << 8,
        W(((iode & 0xFF) << 22), ((crs & 0xFFFF) << 6)),
        W(((deltan & 0xFFFF) << 14), (((m0 >> 24) & 0xFF) << 6)),
        (m0 & 0xFFFFFF) << 6,
        W(((cuc & 0xFFFF) << 14), (((ecc >> 24) & 0xFF) << 6)),
        (ecc & 0xFFFFFF) << 6,
        W(((cus & 0xFFFF) << 14), (((sqrta >> 24) & 0xFF) << 6)),
        (sqrta & 0xFFFFFF) << 6,
        (toe & 0xFFFF) << 14,
    ]

    # Subframe 3 (gps.c:731-740)
    sbf[2] = [
        0x8B0000 << 6,
        0x3 << 8,
        W(((cic & 0xFFFF) << 14), (((omega0 >> 24) & 0xFF) << 6)),
        (omega0 & 0xFFFFFF) << 6,
        W(((cis & 0xFFFF) << 14), (((inc0 >> 24) & 0xFF) << 6)),
        (inc0 & 0xFFFFFF) << 6,
        W(((crc & 0xFFFF) << 14), (((aop >> 24) & 0xFF) << 6)),
        (aop & 0xFFFFFF) << 6,
        (omegadot & 0xFFFFFF) << 6,
        W(((iode & 0xFF) << 22), ((idot & 0x3FFF) << 8)),
    ]

    # Empty pages of subframes 4 and 5: dummy SV, alternating bits
    # (gps.c:742-770).
    for i in range(25):
        svid = 0
        for base, sfid in ((3, 4), (4, 5)):
            sbf[base + i * 2] = [
                0x8B0000 << 6,
                sfid << 8,
                W((data_id << 28), (svid << 22), ((EMPTY_WORD & 0xFFFF) << 6)),
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0xFFFFFF) << 6,
                (EMPTY_WORD & 0x3FFFFF) << 8,
            ]

    def almanac_page(a) -> list[int]:
        e_a = _trunc(a.e / POW2_M21)
        toa = _trunc(a.toa.sec / POW2_12)
        delta_i = _trunc(a.delta_i / POW2_M19)
        omgd = _trunc(a.omegadot / POW2_M38)
        sqa = _trunc(a.sqrta / POW2_M11)
        omg0 = _trunc(a.omega0 / POW2_M23)
        w_a = _trunc(a.aop / POW2_M23)
        m0_a = _trunc(a.m0 / POW2_M23)
        af0_a = _trunc(a.af0 / POW2_M20)
        af1_a = _trunc(a.af1 / POW2_M38)
        return [
            0x8B0000 << 6,
            0,  # caller sets subframe id word
            W((data_id << 28), ((a.svid & 0x3F) << 22), ((e_a & 0xFFFF) << 6)),
            W(((toa & 0xFF) << 22), ((delta_i & 0xFFFF) << 6)),
            (omgd & 0xFFFF) << 14,  # SV health = 000 (all data OK)
            (sqa & 0xFFFFFF) << 6,
            (omg0 & 0xFFFFFF) << 6,
            (w_a & 0xFFFFFF) << 6,
            (m0_a & 0xFFFFFF) << 6,
            W(((af0_a & 0x7F8) << 19), ((af1_a & 0x7FF) << 11), ((af0_a & 0x7) << 8)),
        ]

    # Subframe 4 pages 2-5 / 7-10: almanac for PRN 25-32 (gps.c:772-803).
    for asv in range(24, MAX_SAT):
        i = asv - 23 if asv <= 27 else asv - 22
        a = alm.sv[asv]
        if a.valid != 0:
            page = almanac_page(a)
            page[1] = 0x4 << 8
            sbf[3 + i * 2] = page

    # Subframe 4 page 18: ionospheric and UTC data (gps.c:805-817).
    if ionoutc.vflg:
        sbf[3 + 17 * 2] = [
            0x8B0000 << 6,
            0x4 << 8,
            W(
                (data_id << 28),
                (SBF4_SVID[17] << 22),
                ((alpha0 & 0xFF) << 14),
                ((alpha1 & 0xFF) << 6),
            ),
            W(((alpha2 & 0xFF) << 22), ((alpha3 & 0xFF) << 14), ((beta0 & 0xFF) << 6)),
            W(((beta1 & 0xFF) << 22), ((beta2 & 0xFF) << 14), ((beta3 & 0xFF) << 6)),
            (A1 & 0xFFFFFF) << 6,
            ((A0 >> 8) & 0xFFFFFF) << 6,
            W(((A0 & 0xFF) << 22), ((tot & 0xFF) << 14), ((wnt & 0xFF) << 6)),
            W(((dtls & 0xFF) << 22), ((wnlsf & 0xFF) << 14), ((dn & 0xFF) << 6)),
            (dtlsf & 0xFF) << 22,
        ]

    # Subframe 4 page 25: SV health for PRN 25-32 (gps.c:820-829).
    sbf[3 + 24 * 2] = [
        0x8B0000 << 6,
        0x4 << 8,
        W((data_id << 28), (SBF4_SVID[24] << 22)),
        0, 0, 0, 0, 0, 0, 0,
    ]

    # Subframe 5 pages 1-24: almanac for PRN 1-24 (gps.c:832-859).
    for asv in range(24):
        a = alm.sv[asv]
        if a.svid != 0:
            page = almanac_page(a)
            page[1] = 0x5 << 8
            sbf[4 + asv * 2] = page

    # Subframe 5 page 25: toa/wna + SV health for PRN 1-24 (gps.c:862-883).
    wna = int(eph.toe_week[sv]) % 256
    toa = _trunc(eph.toe_sec[sv] / 4096.0)
    for asv in range(MAX_SAT):
        if alm.sv[asv].svid != 0:
            wna = alm.sv[asv].toa.week % 256
            toa = _trunc(alm.sv[asv].toa.sec / 4096.0)
            break
    sbf[4 + 24 * 2] = [
        0x8B0000 << 6,
        0x5 << 8,
        W((data_id << 28), (SBF5_SVID[24] << 22), ((toa & 0xFF) << 14), ((wna & 0xFF) << 6)),
        0, 0, 0, 0, 0, 0, 0,
    ]

    return sbf.astype(np.uint32)


def generate_nav_msg(
    g: GpsTime, sbf: np.ndarray, dwrd: np.ndarray, ipage: int, init: bool
) -> tuple[GpsTime, int]:
    """Serialize 30 s of nav message into the 60-word dwrd buffer.

    Reference gps.c:2066-2140. ``dwrd`` (uint32[60]) is updated in place:
    on init, words 0-9 are the current page's subframe 5 (so transmission
    can start mid-subframe); otherwise words 50-59 roll to the front. Then
    five fresh subframes fill words 10-59 with incrementing TOW, the
    transmission week in subframe 1, and chained parity.

    Returns (g0, next_ipage) where g0 is the 30 s-aligned data-bit
    reference time stored on the channel.
    """
    g0_sec = float((int(g.sec + 0.5) // 30) * 30.0)
    g0 = GpsTime(g.week, g0_sec)

    wn = g0.week % 1024
    tow = int(g0_sec) // 6

    if init:
        prevwrd = 0
        for iwrd in range(N_DWRD_SBF):
            sbfwrd = int(sbf[4 + ipage * 2][iwrd])
            if iwrd == 1:
                sbfwrd |= (tow & 0x1FFFF) << 13
            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd == 1 or iwrd == 9
            dwrd[iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[iwrd])
    else:
        for iwrd in range(N_DWRD_SBF):
            dwrd[iwrd] = dwrd[N_DWRD_SBF * N_SBF + iwrd]
            prevwrd = int(dwrd[iwrd])

    for isbf in range(N_SBF):
        tow += 1
        for iwrd in range(N_DWRD_SBF):
            if isbf < 3:
                sbfwrd = int(sbf[isbf][iwrd])
            elif isbf == 3:
                sbfwrd = int(sbf[3 + ipage * 2][iwrd])
            else:
                sbfwrd = int(sbf[4 + ipage * 2][iwrd])

            if isbf == 0 and iwrd == 2:
                sbfwrd |= (wn & 0x3FF) << 20
            if iwrd == 1:
                sbfwrd |= (tow & 0x1FFFF) << 13

            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd == 1 or iwrd == 9
            dwrd[(isbf + 1) * N_DWRD_SBF + iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[(isbf + 1) * N_DWRD_SBF + iwrd])

    ipage += 1
    if ipage >= 25:
        ipage = 0
    return g0, ipage


def data_bit(dwrd: np.ndarray, iword: int, ibit: int) -> int:
    """Bit (±1) at word/bit position (reference gps.c:2060, 2812)."""
    return int((int(dwrd[iword]) >> (29 - ibit)) & 0x1) * 2 - 1


# IS-GPS-200 parity hamming vectors for D25..D30 over (D29*, D30*, d1..d24).
# Used for the runtime parity self-check, independently of compute_checksum
# (the same role the reference's validate_parityN/decode_wordN pair plays,
# gps.c:907-1001, called on every emitted word via gps.c:1070).
_HAMMING = (
    0xBB1F3480, 0x5D8F9A40, 0xAEC7CD00,
    0x5763E680, 0x6BB1F340, 0x8B7A89C0,
)


def validate_parity(word: int) -> bool:
    """True if a 32-bit nav word (D29*,D30*,d1..d24,D25..D30) is parity-clean.

    Independent re-derivation from the standard's vectors — shares no code
    with compute_checksum so it can catch its bugs."""
    w = word & 0xFFFFFFFF
    if w & 0x40000000:  # D30* set: data bits arrive inverted
        w ^= 0x3FFFFFC0
    parity = 0
    for mask in _HAMMING:
        parity = (parity << 1) | (bin(w & mask & ~0x3F).count("1") & 1)
    return parity == (word & 0x3F)


def validate_frame(dwrd: np.ndarray) -> list[int]:
    """Indices of parity-failing words in a dwrd buffer (empty == clean).

    Vectorized form of :func:`validate_parity` (same independent Hamming
    vectors, no shared code with compute_checksum): this runs on every
    30 s regeneration for every channel's 60-word buffer, where the
    per-word ``bin().count`` loop measured as real planner time."""
    w = np.asarray(dwrd, dtype=np.uint64)
    data = np.where(w & 0x40000000, w ^ 0x3FFFFFC0, w) & np.uint64(
        0xFFFFFFC0
    )
    parity = np.zeros(len(w), dtype=np.uint64)
    for mask in _HAMMING:
        bit = np.bitwise_count(data & np.uint64(mask)) & np.uint64(1)
        parity = (parity << np.uint64(1)) | bit
    bad = parity != (w & np.uint64(0x3F))
    return list(np.nonzero(bad)[0])


# TLM preamble 10001011 (IS-GPS-200 20.3.3.1), as transmitted bits.
LNAV_PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.uint8)


def decode_data_word(bits: np.ndarray, j: int) -> int | None:
    """Assemble the 30-bit LNAV word at bit offset ``j`` of a demodulated
    stream (D29*/D30* context taken from bits j-2, j-1), validate parity,
    and return the de-inverted 24-bit data field — or None on parity
    failure. Receiver-side inverse of compute_checksum (the reference's
    decode_word, gps.c:907-924)."""
    word = int("".join(map(str, bits[j : j + 30])), 2)
    word |= (int(bits[j - 2]) << 31) | (int(bits[j - 1]) << 30)
    if not validate_parity(word):
        return None
    data = (word >> 6) & 0xFFFFFF
    if word & 0x40000000:  # D30*: data bits arrive inverted on the wire
        data ^= 0xFFFFFF
    return data


assert N_DWRD == 60
