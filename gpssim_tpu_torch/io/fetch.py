"""Network fetchers: hourly RINEX broadcast ephemerides and SEM almanac.

Python equivalents of the reference's libcurl paths — the FTP RINEX pull
from the BKG NRT archive with its ground-station tables (gps.c:36-136,
2388-2467; URL templates gps.h:24-27) and the Celestrak SEM almanac
download (almanac.c:191-220, almanac.h:19). Both are optional features:
callers should treat network failure as a normal, reportable condition.

URL assembly is split out pure (``rinex_url``) so it is unit-testable
without any network.
"""

from __future__ import annotations

import random
import time
import urllib.request

# (4-char id, 9-char id, name) — gps.c:40-45.
STATIONS_V3: tuple[tuple[str, str, str], ...] = (
    ("func", "FUNC00PRT", "Funchal"),
    ("flrs", "FLRS00PRT", "Santa Cruz das Flore"),
    ("pdel", "PDEL00PRT", "PONTA DELGADA"),
)

# gps.c:53-136.
STATIONS_V2: tuple[tuple[str, str, str], ...] = (
    ("abmf", "ABMF00GLP", "Aeroport du Raizet"),
    ("aggo", "AGGO00ARG", "AGGO"),
    ("ajac", "AJAC00FRA", "Ajaccio"),
    ("ankr", "ANKR00TUR", "Ankara"),
    ("areg", "AREG00PER", "Arequipa"),
    ("ascg", "ASCG00SHN", "Ascension"),
    ("bogi", "BOGI00POL", "Borowa Gora"),
    ("bor1", "BOR100POL", "Borowiec"),
    ("brst", "BRST00FRA", "Brest"),
    ("chpg", "CHPG00BRA", "Cachoeira Paulista"),
    ("cibg", "CIBG00IDN", "Cibinong"),
    ("cpvg", "CPVG00CPV", "CAP-VERT"),
    ("djig", "DJIG00DJI", "Djibouti"),
    ("dlf1", "DLF100NLD", "Delft"),
    ("ffmj", "FFMJ00DEU", "Frankfurt/Main"),
    ("ftna", "FTNA00WLF", "Futuna"),
    ("gamb", "GAMB00PYF", "Rikitea"),
    ("gamg", "GAMG00KOR", "Geochang"),
    ("glps", "GLPS00ECU", "Galapagos Permanent Station"),
    ("glsv", "GLSV00UKR", "Kiev/Golosiiv"),
    ("gmsd", "GMSD00JPN", "GUTS Masda"),
    ("gop6", "GOP600CZE", "Pecny, Ondrejov"),
    ("gop7", "GOP700CZE", "Pecny, Ondrejov"),
    ("gope", "GOPE00CZE", "Pecny, Ondrejov"),
    ("grac", "GRAC00FRA", "Grasse"),
    ("gras", "GRAS00FRA", "Observatoire de Calern - OCA"),
    ("holb", "HOLB00CAN", "Holberg"),
    ("hueg", "HUEG00DEU", "Huegelheim"),
    ("ieng", "IENG00ITA", "Torino"),
    ("ista", "ISTA00TUR", "Istanbul"),
    ("izmi", "IZMI00TUR", "Izmir"),
    ("jfng", "JFNG00CHN", "Juifeng"),
    ("joz2", "JOZ200POL", "Jozefoslaw"),
    ("joze", "JOZE00POL", "Jozefoslaw"),
    ("kerg", "KERG00ATF", "Kerguelen Islands"),
    ("kitg", "KITG00UZB", "Kitab"),
    ("koug", "KOUG00GUF", "Kourou"),
    ("krgg", "KRGG00ATF", "Kerguelen Islands"),
    ("krs1", "KRS100TUR", "Kars"),
    ("lama", "LAMA00POL", "Lamkowo"),
    ("leij", "LEIJ00DEU", "Leipzig"),
    ("lmmf", "LMMF00MTQ", "Aeroport Aime CESAIRE-LE LAMENTIN"),
    ("lroc", "LROC00FRA", "La Rochelle"),
    ("mad2", "MAD200ESP", "Madrid Deep Space Tracking Station"),
    ("madr", "MADR00ESP", "Madrid Deep Space Tracking Station"),
    ("mayg", "MAYG00MYT", "Dzaoudzi"),
    ("mers", "MERS00TUR", "Mersin"),
    ("mikl", "MIKL00UKR", "Mykolaiv"),
    ("morp", "MORP00GBR", "Morpeth"),
    ("nklg", "NKLG00GAB", "N'KOLTANG"),
    ("nyal", "NYAL00NOR", "Ny-Alesund"),
    ("nya1", "NYA100NOR", "Ny-Alesund"),
    ("ohi2", "OHI200ATA", "O'Higgins"),
    ("orid", "ORID00MKD", "Ohrid"),
    ("owmg", "OWMG00NZL", "Chatham Island"),
    ("polv", "POLV00UKR", "Poltava"),
    ("ptbb", "PTBB00DEU", "Braunschweig"),
    ("ptgg", "PTGG00PHL", "Manilla"),
    ("rabt", "RABT00MAR", "Rabat, EMI"),
    ("reun", "REUN00REU", "La Reunion - Observatoire Volcanologique"),
    ("rgdg", "RGDG00ARG", "Rio Grande"),
    ("riga", "RIGA00LVA", "RIGA permanent GPS"),
    ("seyg", "SEYG00SYC", "Mahe"),
    ("sofi", "SOFI00BGR", "Sofia"),
    ("stj3", "STJ300CAN", "STJ3 CACS-GSD"),
    ("sulp", "SULP00UKR", "Lviv Polytechnic"),
    ("svtl", "SVTL00RUS", "Svetloe"),
    ("tana", "TANA00ETH", "ILA, Bahir Dar University"),
    ("thtg", "THTG00PYF", "Papeete Tahiti"),
    ("thti", "THTI00PYF", "Tahiti"),
    ("tit2", "TIT200DEU", "Titz / Jackerath"),
    ("tlse", "TLSE00FRA", "Toulouse"),
    ("tro1", "TRO100NOR", "Tromsoe"),
    ("warn", "WARN00DEU", "Warnemuende"),
    ("whit", "WHIT00CAN", "WHIT CACS-GSD"),
    ("wroc", "WROC00POL", "Wroclaw"),
    ("wtza", "WTZA00DEU", "Wettzell"),
    ("yel2", "YEL200CAN", "Yellow Knife"),
    ("zeck", "ZECK00RUS", "Zelenchukskaya"),
    ("zim2", "ZIM200CHE", "Zimmerwald"),
    ("zimm", "ZIMM00CHE", "Zimmerwald L+T 88"),
)

RINEX_FTP_URL = "ftp://igs.bkg.bund.de/IGS/"
RINEX2_SUBFOLDER = "nrt"
RINEX3_SUBFOLDER = "nrt_v3"
ALMANAC_SEM_URL = "https://www.celestrak.com/GPS/almanac/SEM/almanac.sem.txt"


class FetchError(RuntimeError):
    pass


def select_station(
    station_id: str | None, version: int = 2, rng: random.Random | None = None
) -> tuple[str, str, str]:
    """Match a station by 4- or 9-char ID; random pick when none given
    (gps.c:2399-2420). Unknown IDs fall back to the first station."""
    table = STATIONS_V3 if version == 3 else STATIONS_V2
    if station_id is None:
        return (rng or random).choice(table)
    for st in table:
        if st[0] == station_id[:4].lower() or st[1] == station_id[:9].upper():
            return st
    return table[0]


def rinex_url(
    station4: str, when: time.struct_time | None = None, version: int = 2
) -> str:
    """Hourly NRT file URL for the hour *before* ``when`` (gps.c:2422-2431).

    Template: {base}{nrt|nrt_v3}/DDD/HH/ssssDDDh.YYn.gz with h = 'a' + hour.
    """
    tm = when if when is not None else time.gmtime()
    hour = tm.tm_hour - 1
    yday = tm.tm_yday
    if hour < 0:
        hour = 23  # reference keeps the same day (gps.c:2424-2427)
    sub = RINEX3_SUBFOLDER if version == 3 else RINEX2_SUBFOLDER
    return (
        f"{RINEX_FTP_URL}{sub}/{yday:03d}/{hour:02d}/"
        f"{station4}{yday:03d}{chr(ord('a') + hour)}.{tm.tm_year % 100:02d}n.gz"
    )


def fetch_rinex(
    station_id: str | None = None,
    version: int = 2,
    out_path: str = "rinex.gz",
    timeout: float = 30.0,
    base_url: str | None = None,
) -> str:
    """Download the latest hourly RINEX nav file; returns the local path.

    ``base_url`` overrides the archive root (testing / mirrors)."""
    st = select_station(station_id, version)
    url = rinex_url(st[0], version=version)
    if base_url is not None:
        url = base_url.rstrip("/") + "/" + url.rsplit("/", 1)[1]
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            data = resp.read()
    except Exception as e:  # URLError, socket timeout, ftplib errors
        raise FetchError(f"RINEX download failed from {url}: {e}") from e
    with open(out_path, "wb") as fp:
        fp.write(data)
    return out_path


def fetch_almanac(
    out_path: str = "almanac.sem",
    timeout: float = 30.0,
    url: str = ALMANAC_SEM_URL,
) -> str:
    """Download the current SEM almanac (almanac.c:191-220)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            data = resp.read()
    except Exception as e:
        raise FetchError(f"almanac download failed: {e}") from e
    with open(out_path, "wb") as fp:
        fp.write(data)
    return out_path
