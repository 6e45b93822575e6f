"""Date strings as pandas' ``read_json(convert_dates=True)`` reads them in
a date-like column — the reader the reference's JSON loader uses under
``field`` — with the standard library only (the port imports neither
pandas nor dateutil).

pandas tries ``to_datetime`` with three formats in turn and keeps the
strings when all three fail (``Parser._try_convert_to_date``):

1. ``None``: a ``strftime`` format guessed from the first value
   (:func:`guess_format`, pandas' ``guess_datetime_format``), every value
   then parsed with it exactly (:func:`_strptime`); with no guess, each
   value on its own as in 3;
2. ``"iso8601"``: every value ISO 8601 (:func:`_iso`);
3. ``"mixed"``: each value ISO 8601, else pandas' ``parse_datetime_string``
   (:func:`_parse_one`): ``MM/DD/YYYY``-like dates, years and quarters,
   then dateutil's parser (:func:`_dateutil`, a port of
   ``dateutil.parser._parser`` at its defaults, month before day).

A value is a :class:`Stamp`: the wall time, its nanoseconds past the
microsecond, and its zone (None, ``"UTC"`` or an offset in seconds). One
column holds one zone, or none, else the conversion fails; more than six
fraction digits give nanosecond precision.
"""

from __future__ import annotations

import calendar
import datetime
import re
import time
from decimal import Decimal, InvalidOperation
from typing import NamedTuple, Optional, Union

Zone = Union[None, str, int]


class Stamp(NamedTuple):
    wall: datetime.datetime
    nanos: int = 0  # nanoseconds past ``wall``'s microsecond
    zone: Zone = None
    ns_digits: bool = False  # more than six fraction digits


class _Fail(ValueError):
    """The conversion of a column fails (pandas raises; the strings stay)."""


VALUE_ITEM = "ROADMAP.md §1, values only pandas or Arrow holds"
#: pandas' ``nat_strings``; an empty string is missing too.
NAT_STRINGS = {"NaT", "nat", "NAT", "nan", "NaN", "NAN"}

# --- dateutil's lexer and parser (``dateutil.parser._parser``) ---------------

_JUMP = {" ", ".", ",", ";", "-", "/", "'", "at", "on", "and", "ad", "m", "t", "of",
         "st", "nd", "rd", "th"}
_WEEKDAYS = {n.lower(): i for i, names in enumerate(
    [("Mon", "Monday"), ("Tue", "Tuesday"), ("Wed", "Wednesday"), ("Thu", "Thursday"),
     ("Fri", "Friday"), ("Sat", "Saturday"), ("Sun", "Sunday")]) for n in names}
_MONTHS = {n.lower(): i + 1 for i, names in enumerate(
    [("Jan", "January"), ("Feb", "February"), ("Mar", "March"), ("Apr", "April"),
     ("May", "May"), ("Jun", "June"), ("Jul", "July"), ("Aug", "August"),
     ("Sep", "Sept", "September"), ("Oct", "October"), ("Nov", "November"),
     ("Dec", "December")]) for n in names}
_HMS = {n: i for i, names in enumerate([("h", "hour", "hours"), ("m", "minute", "minutes"),
                                        ("s", "second", "seconds")]) for n in names}
_AMPM = {"am": 0, "a": 0, "pm": 1, "p": 1}
_UTCZONE = ["UTC", "GMT", "Z", "z"]


def _lex(s: str) -> list[str]:
    """``_timelex.split``: runs of letters, of digits, single other
    characters, with the dot / comma rules for decimals."""
    chars, out = list(s.replace("\x00", "")), []
    while chars:
        token, state, seen_letters = None, None, False
        while chars:
            c = chars.pop(0)
            if state is None:
                token = c
                if c.isalpha():
                    state = "a"
                elif c.isdigit():
                    state = "0"
                else:
                    token = " " if c.isspace() else c
                    break
            elif state == "a":
                seen_letters = True
                if c.isalpha():
                    token += c
                elif c == ".":
                    token, state = token + c, "a."
                else:
                    chars.insert(0, c)
                    break
            elif state == "0":
                if c.isdigit():
                    token += c
                elif c == "." or (c == "," and len(token) >= 2):
                    token, state = token + c, "0."
                else:
                    chars.insert(0, c)
                    break
            elif state == "a.":
                seen_letters = True
                if c == "." or c.isalpha():
                    token += c
                elif c.isdigit() and token[-1] == ".":
                    token, state = token + c, "0."
                else:
                    chars.insert(0, c)
                    break
            else:  # "0."
                if c == "." or c.isdigit():
                    token += c
                elif c.isalpha() and token[-1] == ".":
                    token, state = token + c, "a."
                else:
                    chars.insert(0, c)
                    break
        if state in ("a.", "0.") and (seen_letters or token.count(".") > 1
                                      or token[-1] in ".,"):
            parts = re.split("([.,])", token)
            out.append(parts[0])
            out.extend(p for p in parts[1:] if p)
            continue
        if state == "0." and token.count(".") == 0:
            token = token.replace(",", ".")
        out.append(token)
    return out


class _Res:
    def __init__(self) -> None:
        self.year = self.month = self.day = self.weekday = None
        self.hour = self.minute = self.second = self.microsecond = None
        self.tzname = self.tzoffset = self.ampm = None
        self.century_specified = False


class _YMD(list):
    def __init__(self) -> None:
        super().__init__()
        self.century_specified = False
        self.dstridx = self.mstridx = self.ystridx = None

    def could_be_day(self, value) -> bool:
        if self.dstridx is not None:
            return False
        if self.mstridx is None:
            return 1 <= value <= 31
        year = 2000 if self.ystridx is None else self[self.ystridx]
        return 1 <= value <= calendar.monthrange(year, self[self.mstridx])[1]

    def append(self, val, label=None) -> None:
        if isinstance(val, str):
            if val.isdigit() and len(val) > 2:
                self.century_specified = True
                if label not in (None, "Y"):
                    raise ValueError(label)
                label = "Y"
        elif val > 100:
            self.century_specified = True
            if label not in (None, "Y"):
                raise ValueError(label)
            label = "Y"
        super().append(int(val))
        for lab, attr in (("M", "mstridx"), ("D", "dstridx"), ("Y", "ystridx")):
            if label == lab:
                if getattr(self, attr) is not None:
                    raise ValueError(f"{lab} is already set")
                setattr(self, attr, len(self) - 1)

    def resolve(self):
        strids = {k: v for k, v in (("y", self.ystridx), ("m", self.mstridx),
                                    ("d", self.dstridx)) if v is not None}
        if len(self) == len(strids) > 0 or (len(self) == 3 and len(strids) == 2):
            if len(self) == 3 and len(strids) == 2:
                missing = [x for x in range(3) if x not in strids.values()]
                key = [x for x in "ymd" if x not in strids]
                strids[key[0]] = missing[0]
            return tuple(self[strids[k]] if k in strids else None for k in "ymd")
        year = month = day = None
        m = self.mstridx
        if len(self) > 3:
            raise ValueError("More than three YMD values")
        if len(self) == 1 or (m is not None and len(self) == 2):
            if m is not None:
                month, other = self[m], self[m - 1]
            else:
                other = self[0]
            if len(self) > 1 or m is None:
                if other > 31:
                    year = other
                else:
                    day = other
        elif len(self) == 2:
            if self[0] > 31:
                year, month = self
            elif self[1] > 31:
                month, year = self
            else:
                month, day = self
        elif len(self) == 3:
            if m == 0:
                month, day, year = (self[0], self[2], self[1]) if self[1] > 31 else self
            elif m == 1:
                if self[0] > 31:
                    year, month, day = self
                else:
                    day, month, year = self
            elif m == 2:
                if self[1] > 31:
                    day, year, month = self
                else:
                    year, day, month = self
            elif self[0] > 31 or self.ystridx == 0:
                year, month, day = self
            elif self[0] > 12:
                day, month, year = self
            else:
                month, day, year = self
        return year, month, day


def _decimal(text: str) -> Decimal:
    try:
        d = Decimal(text)
    except InvalidOperation as e:
        raise ValueError(text) from e
    if not d.is_finite():
        raise ValueError(text)
    return d


def _convert_year(year: int, century_specified: bool) -> int:
    now = time.localtime().tm_year
    if year < 100 and not century_specified:
        year += now // 100 * 100
        if year >= now + 50:
            year -= 100
        elif year < now - 50:
            year += 100
    return year


def _parsems(value: str) -> tuple[int, int]:
    if "." not in value:
        return int(value), 0
    i, f = value.split(".")
    return int(i), int(f.ljust(6, "0")[:6])


def _min_sec(value: Decimal) -> tuple[int, Optional[int]]:
    rem = value % 1
    return int(value), (int(60 * rem) if rem else None)


def _adjust_ampm(hour: int, ampm: int) -> int:
    if hour < 12 and ampm == 1:
        return hour + 12
    if hour == 12 and ampm == 0:
        return 0
    return hour


def _hms_idx(idx: int, tokens: list[str]) -> Optional[int]:
    n = len(tokens)
    if idx + 1 < n and tokens[idx + 1].lower() in _HMS:
        return idx + 1
    if idx + 2 < n and tokens[idx + 1] == " " and tokens[idx + 2].lower() in _HMS:
        return idx + 2
    if idx > 0 and tokens[idx - 1].lower() in _HMS:
        return idx - 1
    if 1 < idx == n - 1 and tokens[idx - 1] == " " and tokens[idx - 2].lower() in _HMS:
        return idx - 2
    return None


def _numeric_token(tokens: list[str], idx: int, ymd: _YMD, res: _Res) -> int:
    """``parser._parse_numeric_token`` (not fuzzy)."""
    text = tokens[idx]
    value = _decimal(text)
    n, n_tok = len(text), len(tokens)
    if (len(ymd) == 3 and n in (2, 4) and res.hour is None
            and (idx + 1 >= n_tok or (tokens[idx + 1] != ":"
                                      and tokens[idx + 1].lower() not in _HMS))):
        res.hour = int(text[:2])
        if n == 4:
            res.minute = int(text[2:])
    elif n == 6 or (n > 6 and text.find(".") == 6):
        if not ymd and "." not in text:
            ymd.append(text[:2])
            ymd.append(text[2:4])
            ymd.append(text[4:])
        else:
            res.hour, res.minute = int(text[:2]), int(text[2:4])
            res.second, res.microsecond = _parsems(text[4:])
    elif n in (8, 12, 14):
        ymd.append(text[:4], "Y")
        ymd.append(text[4:6])
        ymd.append(text[6:8])
        if n > 8:
            res.hour, res.minute = int(text[8:10]), int(text[10:12])
            if n > 12:
                res.second = int(text[12:])
    elif (hms_idx := _hms_idx(idx, tokens)) is not None:
        if hms_idx > idx:
            hms, idx = _HMS[tokens[hms_idx].lower()], hms_idx
        else:
            hms = _HMS[tokens[hms_idx].lower()] + 1
        if hms == 0:
            res.hour = int(value)
            if value % 1:
                res.minute = int(60 * (value % 1))
        elif hms == 1:
            res.minute, res.second = _min_sec(value)
        elif hms == 2:
            res.second, res.microsecond = _parsems(text)
    elif idx + 2 < n_tok and tokens[idx + 1] == ":":
        res.hour = int(value)
        res.minute, res.second = _min_sec(_decimal(tokens[idx + 2]))
        if idx + 4 < n_tok and tokens[idx + 3] == ":":
            res.second, res.microsecond = _parsems(tokens[idx + 4])
            idx += 2
        idx += 2
    elif idx + 1 < n_tok and tokens[idx + 1] in ("-", "/", "."):
        sep = tokens[idx + 1]
        ymd.append(text)
        if idx + 2 < n_tok and tokens[idx + 2].lower() not in _JUMP:
            if tokens[idx + 2].isdigit():
                ymd.append(tokens[idx + 2])
            elif tokens[idx + 2].lower() in _MONTHS:
                ymd.append(_MONTHS[tokens[idx + 2].lower()], "M")
            else:
                raise ValueError(text)
            if idx + 3 < n_tok and tokens[idx + 3] == sep:
                month = _MONTHS.get(tokens[idx + 4].lower())
                if month is not None:
                    ymd.append(month, "M")
                else:
                    ymd.append(tokens[idx + 4])
                idx += 2
            idx += 1
        idx += 1
    elif idx + 1 >= n_tok or tokens[idx + 1].lower() in _JUMP:
        if idx + 2 < n_tok and tokens[idx + 2].lower() in _AMPM:
            res.hour = _adjust_ampm(int(value), _AMPM[tokens[idx + 2].lower()])
            idx += 1
        else:
            ymd.append(value)
        idx += 1
    elif tokens[idx + 1].lower() in _AMPM and 0 <= value < 24:
        res.hour = _adjust_ampm(int(value), _AMPM[tokens[idx + 1].lower()])
        idx += 1
    elif ymd.could_be_day(value):
        ymd.append(value)
    else:
        raise ValueError(text)
    return idx


def _could_be_tzname(res: _Res, token: str) -> bool:
    return (res.hour is not None and res.tzname is None and res.tzoffset is None
            and len(token) <= 5 and (all("A" <= c <= "Z" for c in token)
                                     or token in _UTCZONE))


def _dateutil_res(text: str) -> Optional[_Res]:
    """``parser._parse(text)`` at dayfirst / yearfirst False, not fuzzy:
    the fields found, or None."""
    res, ymd = _Res(), _YMD()
    tokens = _lex(text)
    i = 0
    try:
        while i < len(tokens):
            tok = tokens[i]
            low = tok.lower()
            try:
                float(tok)
                numeric = True
            except ValueError:
                numeric = False
            if numeric:
                i = _numeric_token(tokens, i, ymd, res)
            elif low in _WEEKDAYS:
                res.weekday = _WEEKDAYS[low]
            elif low in _MONTHS:
                ymd.append(_MONTHS[low], "M")
                if i + 1 < len(tokens):
                    if tokens[i + 1] in ("-", "/"):
                        sep = tokens[i + 1]
                        ymd.append(tokens[i + 2])
                        if i + 3 < len(tokens) and tokens[i + 3] == sep:
                            ymd.append(tokens[i + 4])
                            i += 2
                        i += 2
                    elif (i + 4 < len(tokens) and tokens[i + 1] == tokens[i + 3] == " "
                          and tokens[i + 2].lower() == "of"):
                        if tokens[i + 4].isdigit():
                            ymd.append(str(_convert_year(int(tokens[i + 4]), False)), "Y")
                        i += 4
            elif low in _AMPM:
                if res.hour is None:
                    raise ValueError("No hour specified with AM or PM flag.")
                if not 0 <= res.hour <= 12:
                    raise ValueError("Invalid hour specified for 12-hour clock.")
                res.hour = _adjust_ampm(res.hour, _AMPM[low])
                res.ampm = _AMPM[low]
            elif _could_be_tzname(res, tok):
                res.tzname = tok
                res.tzoffset = 0 if tok == "z" else None  # dateutil's lower-case lookup
                if i + 1 < len(tokens) and tokens[i + 1] in ("+", "-"):
                    tokens[i + 1] = ("+", "-")[tokens[i + 1] == "+"]
                    res.tzoffset = None
                    if tok.lower() in ("utc", "gmt", "z"):
                        res.tzname = None
            elif res.hour is not None and tok in ("+", "-"):
                sign = (-1, 1)[tok == "+"]
                n = len(tokens[i + 1])
                if n == 4:
                    hours, minutes = int(tokens[i + 1][:2]), int(tokens[i + 1][2:])
                elif i + 2 < len(tokens) and tokens[i + 2] == ":":
                    hours, minutes = int(tokens[i + 1]), int(tokens[i + 3])
                    i += 2
                elif n <= 2:
                    hours, minutes = int(tokens[i + 1][:2]), 0
                else:
                    raise ValueError(text)
                res.tzoffset = sign * (hours * 3600 + minutes * 60)
                if (i + 5 < len(tokens) and tokens[i + 2].lower() in _JUMP
                        and tokens[i + 3] == "(" and tokens[i + 5] == ")"
                        and 3 <= len(tokens[i + 4])
                        and res.hour is not None and res.tzname is None
                        and len(tokens[i + 4]) <= 5
                        and (all("A" <= c <= "Z" for c in tokens[i + 4])
                             or tokens[i + 4] in _UTCZONE)):
                    res.tzname = tokens[i + 4]
                    i += 4
                i += 1
            elif low not in _JUMP:
                raise ValueError(text)
            i += 1
        res.year, res.month, res.day = ymd.resolve()
        res.century_specified = ymd.century_specified
    except (IndexError, ValueError, InvalidOperation):
        return None
    if res.year is not None:
        res.year = _convert_year(res.year, res.century_specified)
    if (res.tzoffset == 0 and not res.tzname) or res.tzname in ("Z", "z"):
        res.tzname, res.tzoffset = "UTC", 0
    elif res.tzoffset != 0 and res.tzname and res.tzname.lower() in ("utc", "gmt", "z"):
        res.tzoffset = 0
    return res


_FIELDS = ("year", "month", "day", "hour", "minute", "second", "microsecond")


def _dateutil(text: str, default: datetime.datetime) -> Stamp:
    """pandas' ``dateutil_parse``: the fields dateutil found over
    ``default``, a weekday without a day moved forward to it, and the
    zone (a name other than UTC raises)."""
    res = _dateutil_res(text)
    if res is None:
        raise _Fail(f"Unknown datetime string format, unable to parse: {text}")
    repl = {f: getattr(res, f) for f in _FIELDS if getattr(res, f) is not None}
    if not repl:
        raise _Fail(f"Unable to parse datetime string: {text}")
    try:
        wall = default.replace(**repl)
    except (ValueError, OverflowError) as e:
        raise _Fail(text) from e
    if res.weekday is not None and not res.day:
        wall += datetime.timedelta(days=(res.weekday - wall.weekday()) % 7)
    if res.tzname and res.tzname in time.tzname:
        if res.tzname != "UTC":
            raise NotImplementedError(f"{text!r}: the local zone name {res.tzname!r} "
                                      f"(pandas reads it through the host's zone; {VALUE_ITEM})")
        zone: Zone = "UTC"
    elif res.tzoffset == 0:
        zone = "UTC"
    elif res.tzoffset:
        if abs(res.tzoffset) >= 86400:
            raise _Fail(text)
        zone = res.tzoffset
    elif res.tzname is not None:
        raise _Fail(f"{text}: unknown zone {res.tzname}")
    else:
        zone = None
    return Stamp(wall, 0, zone)


# --- pandas' own parsers ------------------------------------------------------


def _looks_like_datetime(text: str) -> bool:
    """pandas' ``does_string_look_like_datetime``."""
    if not text:
        return True
    if text[0] == "0":
        return True
    if text in ("a", "A", "m", "M", "p", "P", "t", "T"):
        return False
    if re.fullmatch(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*", text):
        return float(text) >= 1000
    return True


def _delimited(text: str) -> Optional[datetime.datetime]:
    """pandas' ``_parse_delimited_date``: ``MM/DD/YYYY`` (day first when
    the month is above 12) with ``/``, ``-``, ``.`` or a blank, and
    ``MM/YYYY``; None for other shapes."""
    delim = " /-."
    n, s = len(text), text

    def num(part: str) -> int:
        return int(part) if part.isascii() and part.isdigit() else -1

    day, can_swap = 1, True
    if n == 10 and s[2] in delim and s[5] in delim:
        month, day, year = num(s[:2]), num(s[3:5]), num(s[6:10])
    elif n == 9 and s[1] in delim and s[4] in delim:
        month, day, year = num(s[:1]), num(s[2:4]), num(s[5:9])
    elif n == 9 and s[2] in delim and s[4] in delim:
        month, day, year = num(s[:2]), num(s[3:4]), num(s[5:9])
    elif n == 8 and s[1] in delim and s[3] in delim:
        month, day, year = num(s[:1]), num(s[2:3]), num(s[4:8])
    elif n == 7 and s[2] in delim:
        if s[2] == ".":
            return None
        month, year, can_swap = num(s[:2]), num(s[3:7]), False
    else:
        return None
    if month < 0 or day < 0 or year < 1000:
        return None
    if 1 <= month <= 31 and 1 <= day <= 31 and (month <= 12 or day <= 12):
        if month > 12 and can_swap:
            day, month = month, day
        try:
            return datetime.datetime(year, month, day)
        except ValueError as e:
            raise _Fail(text) from e
    raise _Fail(f"Invalid date specified ({month}/{day})")


def _date_abbr(text: str) -> Optional[datetime.datetime]:
    """pandas' ``_parse_dateabbr_string`` over 0001-01-01: a 4-character
    year, a quarter (``2024Q1``, ``1Q24``), ``%Y-%m``, ``%b %Y``,
    ``%b-%Y``; None otherwise."""
    s = text.upper()
    if len(s) == 4:
        try:
            return datetime.datetime(int(s), 1, 1)
        except ValueError:
            pass
    if 4 <= len(s) <= 7:
        i = s.find("Q", 1, 6)
        try:
            if i < 0:
                raise ValueError(s)
            if i == 1:
                quarter = int(s[0])
                if len(s) == 4 or (len(s) == 5 and s[i + 1] == "-"):
                    year = 2000 + int(s[-2:])
                elif len(s) == 6 or (len(s) == 7 and s[i + 1] == "-"):
                    year = int(s[-4:])
                else:
                    raise ValueError(s)
            elif i in (2, 3):
                if len(s) == 4 or (len(s) == 5 and s[i - 1] == "-"):
                    quarter, year = int(s[-1]), 2000 + int(s[:2])
                else:
                    raise ValueError(s)
            elif len(s) == 6 or (len(s) == 7 and s[i - 1] == "-"):
                quarter, year = int(s[-1]), int(s[:4])
            else:
                raise ValueError(s)
            if not 1 <= quarter <= 4:
                raise _Fail(f"Incorrect quarterly string is given, quarter must be between "
                            f"1 and 4: {text}")
            return datetime.datetime(year, (quarter - 1) * 3 + 1, 1)
        except _Fail:
            raise
        except ValueError:
            pass
    for pat in ("%Y-%m", "%b %Y", "%b-%Y"):
        try:
            return datetime.datetime.strptime(s, pat)
        except ValueError:
            pass
    return None


def _iso(text: str) -> Optional[Stamp]:
    """pandas' ISO 8601 reader (``parse_iso_8601_datetime``): the stamp,
    or None where the string is no ISO 8601 date time."""
    s, i, n = text, 0, len(text)

    def digit(k: int) -> bool:
        return k < n and "0" <= s[k] <= "9"

    while i < n and s[i].isspace():
        i += 1
    negative = i < n and s[i] == "-"
    i += negative
    if not all(digit(i + k) for k in range(4)):
        return None
    year, i = int(s[i:i + 4]), i + 4
    if negative or year == 0:
        raise NotImplementedError(f"{text!r}: a year before 1 (the reference's loader fails "
                                  f"on it; {VALUE_ITEM})")
    month = day = 1
    hour = minute = second = us = ns = 0
    frac_digits, zone = 0, None
    if i == n:
        return Stamp(datetime.datetime(year, 1, 1))
    sep = None
    if not digit(i):
        if s[i] not in "-./\\ ":
            return None
        sep, i = s[i], i + 1
        if not digit(i):
            return None
    month, i = int(s[i]), i + 1
    if digit(i):
        month, i = month * 10 + int(s[i]), i + 1
    elif sep is None:
        return None
    if not 1 <= month <= 12:
        return None
    if i == n:
        return Stamp(datetime.datetime(year, month, 1)) if sep is not None else None
    if sep is not None:
        if s[i] != sep or i + 1 == n:
            return None
        i += 1
    if not digit(i):
        return None
    day, i = int(s[i]), i + 1
    if digit(i):
        day, i = day * 10 + int(s[i]), i + 1
    elif sep is None:
        return None
    if not 1 <= day <= calendar.monthrange(year, month)[1]:
        return None
    if i < n:
        if s[i] not in "T " or i + 1 == n:
            return None
        i += 1
        if not digit(i):
            return None
        hour, i = int(s[i]), i + 1
        two = digit(i)
        if two:
            hour, i = hour * 10 + int(s[i]), i + 1
            if hour >= 24:
                return None
        hms_sep = False
        if i == n:
            if not two:
                return None
        elif s[i] == ":" or digit(i):
            if s[i] == ":":
                hms_sep, i = True, i + 1
                if not digit(i):
                    return None
            minute, i = int(s[i]), i + 1
            if digit(i):
                minute, i = minute * 10 + int(s[i]), i + 1
                if minute >= 60:
                    return None
            elif not hms_sep:
                return None
            if i < n and ((hms_sep and s[i] == ":") or (not hms_sep and digit(i))):
                if hms_sep:
                    i += 1
                    if not digit(i):
                        return None
                second, i = int(s[i]), i + 1
                if digit(i):
                    second, i = second * 10 + int(s[i]), i + 1
                    if second >= 60:
                        return None
                elif not hms_sep:
                    return None
                if i < n and s[i] == ".":
                    i += 1
                    start = i
                    while digit(i):
                        i += 1
                    digits = s[start:i]
                    frac_digits = len(digits)
                    padded = digits[:9].ljust(9, "0")
                    us, ns = int(padded[:6]), int(padded[6:9])
        elif not two:
            return None
        while i < n and s[i].isspace():
            i += 1
        if i < n and s[i] == "Z":
            zone, i = "UTC", i + 1
        elif i < n and s[i] in "+-":
            neg, i = s[i] == "-", i + 1
            if digit(i) and digit(i + 1):
                oh, i = int(s[i:i + 2]), i + 2
                if oh >= 24:
                    return None
            elif digit(i):
                oh, i = int(s[i]), i + 1
            else:
                return None
            om = 0
            if i < n:
                if s[i] == ":":
                    i += 1
                if digit(i) and digit(i + 1):
                    om, i = int(s[i:i + 2]), i + 2
                    if om >= 60:
                        return None
                elif digit(i):
                    om, i = int(s[i]), i + 1
                else:
                    return None
            off = (oh * 3600 + om * 60) * (-1 if neg else 1)
            zone = "UTC" if off == 0 else off
        while i < n and s[i].isspace():
            i += 1
        if i != n:
            return None
    if frac_digits > 18:
        return None
    wall = datetime.datetime(year, month, day, hour, minute, second, us)
    return Stamp(wall, ns, zone, frac_digits > 6)


_TODAY = ("now", "today")


def _parse_one(text: str) -> Optional[Stamp]:
    """One value as pandas' ``array_to_datetime`` reads a string (None:
    missing): ISO 8601, else ``parse_datetime_string``."""
    if text == "" or text in NAT_STRINGS:
        return None
    if text in _TODAY:
        raise NotImplementedError(f"{text!r} reads the clock in the reference ({VALUE_ITEM})")
    stamp = _iso(text)
    if stamp is not None:
        return stamp
    if not _looks_like_datetime(text):
        raise _Fail(f"{text!r} is not likely a datetime")
    if re.match(r"([01]?[0-9]|2[0-3]):([0-5][0-9])", text):
        today = datetime.datetime.now().replace(hour=0, minute=0, second=0, microsecond=0)
        return _dateutil(text, today)
    day = _delimited(text)
    if day is not None:
        return Stamp(day)
    day = _date_abbr(text)
    if day is not None:
        return Stamp(day)
    return _dateutil(text, datetime.datetime(1, 1, 1))


# --- pandas' guess_datetime_format and strptime -------------------------------

_GUESS_ORDER = (
    (("year", "month", "day", "hour", "minute", "second"), "%Y%m%d%H%M%S", 0),
    (("year", "month", "day", "hour", "minute"), "%Y%m%d%H%M", 0),
    (("year", "month", "day", "hour"), "%Y%m%d%H", 0),
    (("year", "month", "day"), "%Y%m%d", 0),
    (("hour", "minute", "second"), "%H%M%S", 0),
    (("hour", "minute"), "%H%M", 0),
    (("year",), "%Y", 4),
    (("month",), "%B", 0),
    (("month",), "%b", 0),
    (("month",), "%m", 2),
    (("day",), "%d", 2),
    (("hour",), "%H", 2),
    (("minute",), "%M", 2),
    (("second",), "%S", 2),
    (("second", "microsecond"), "%S.%f", 0),
    (("tzinfo",), "%z", 0),
    (("tzinfo",), "%Z", 0),
    (("day_of_week",), "%a", 0),
    (("day_of_week",), "%A", 0),
    (("meridiem",), "%p", 0),
)


def _strftime(stamp: Stamp, fmt: str) -> str:
    """``datetime.strftime`` of a parsed stamp, with dateutil's zones:
    ``%z`` ``+HHMM``, ``%Z`` ``UTC`` or an offset's empty name."""
    out = fmt
    if "%z" in out or "%Z" in out:
        if stamp.zone is None:
            z = name = ""
        elif stamp.zone == "UTC":
            z, name = "+0000", "UTC"
        else:
            off = int(stamp.zone)
            sign = "-" if off < 0 else "+"
            z, name = f"{sign}{abs(off) // 3600:02d}{abs(off) % 3600 // 60:02d}", ""
        out = out.replace("%z", z).replace("%Z", name)
    return stamp.wall.strftime(out)


def _fill_token(token: str, padding: int) -> str:
    if re.search(r"\d+\.\d+", token) is None:
        return token.zfill(padding)
    seconds, nanos = token.split(".")
    return f"{int(seconds):02d}.{nanos.ljust(9, '0')[:6]}"


def _pandas_lex(text: str) -> list[str]:
    """pandas' own ``_timelex.split`` (``guess_datetime_format``'s
    tokens): blanks, decimals, digits, ASCII letters, runs of ``./:``,
    runs of anything else; ``59 , 456`` joins into ``59.456``."""
    tokens: list = re.findall(r"\s|(?<![\.\d])\d+\.\d+(?![\.\d])|\d+|[a-zA-Z]+|[\./:]+"
                              r"|[^\da-zA-Z\./:\s]+", text.replace("\x00", ""))
    for n in range(len(tokens) - 2):
        tok = tokens[n]
        if (tok is not None and tok.isdigit() and tokens[n + 1] == ","
                and tokens[n + 2] is not None and tokens[n + 2].isdigit()):
            tokens[n], tokens[n + 1], tokens[n + 2] = tok + "." + tokens[n + 2], None, None
    return [t for t in tokens if t is not None]


def guess_format(text: str) -> Optional[str]:
    """pandas' ``guess_datetime_format(text)`` (month before day)."""
    default = datetime.datetime.now().replace(hour=0, minute=0, second=0, microsecond=0)
    try:
        parsed = _dateutil(text, default)
    except (ValueError, NotImplementedError):
        return None
    tokens = _pandas_lex(text)
    if parsed.zone is not None:
        # pandas joins a trailing offset ("Z", "+ 0900", "+ 09 : 00") into one token
        at = None
        if tokens and tokens[-1] == "Z":
            at = -1
        elif len(tokens) > 1 and tokens[-2] in ("+", "-"):
            at = -2
        elif len(tokens) > 3 and tokens[-4] in ("+", "-"):
            at = -4
        if at is not None:
            tokens[at] = _strftime(parsed, "%z")
            tokens = tokens[:at + 1 or None]
    guess: list[Optional[str]] = [None] * len(tokens)
    found: set = set()
    for attrs, fmt, padding in _GUESS_ORDER:
        if set(attrs) & found or (parsed.zone is None and fmt in ("%z", "%Z")):
            continue
        want = _strftime(parsed, fmt)
        for i, tok_fmt in enumerate(guess):
            filled = _fill_token(tokens[i], padding)
            if tok_fmt is None and filled == want:
                guess[i], tokens[i] = fmt, filled
                found.update(attrs)
                break
    if (len({"year", "month", "day"} & found) != 3 and guess != ["%Y"]
            and not (guess == ["%Y", None, "%m"] and tokens[1] == "-")):
        return None
    out = []
    for tok, g in zip(tokens, guess):
        if g is not None:
            out.append(g)
            continue
        try:
            float(tok)
            return None
        except ValueError:
            out.append(tok)
    if "%p" in out and "%H" in out:
        out[out.index("%H")] = "%I"
    fmt = "".join(out)
    try:
        _strptime_one(text, fmt)
    except (_Fail, NotImplementedError):
        return None
    return fmt if _strftime(parsed, fmt) == "".join(tokens) else None


_DIRECTIVES = {
    "d": r"(?P<d>3[01]|[12]\d|0[1-9]|[1-9]| [1-9])",
    "f": r"(?P<f>[0-9]{1,9})",
    "H": r"(?P<H>2[0-3]|[0-1]\d|\d)",
    "I": r"(?P<I>1[0-2]|0[1-9]|[1-9])",
    "m": r"(?P<m>1[0-2]|0[1-9]|[1-9])",
    "M": r"(?P<M>[0-5]\d|\d)",
    "S": r"(?P<S>6[0-1]|[0-5]\d|\d)",
    "Y": r"(?P<Y>\d\d\d\d)",
    "z": r"(?P<z>[+-]\d\d:?[0-5]\d(:?[0-5]\d(\.\d{1,6})?)?|(?-i:Z))",
    "Z": r"(?P<Z>utc|gmt)",
    "a": "(?P<a>" + "|".join(sorted((n.lower() for n in calendar.day_abbr), key=len,
                                    reverse=True)) + ")",
    "A": "(?P<A>" + "|".join(sorted((n.lower() for n in calendar.day_name), key=len,
                                    reverse=True)) + ")",
    "b": "(?P<b>" + "|".join(sorted((n.lower() for n in calendar.month_abbr[1:]), key=len,
                                    reverse=True)) + ")",
    "B": "(?P<B>" + "|".join(sorted((n.lower() for n in calendar.month_name[1:]), key=len,
                                    reverse=True)) + ")",
    "p": r"(?P<p>am|pm)",
}


def _format_regex(fmt: str) -> re.Pattern:
    """Python's ``_strptime.TimeRE.pattern`` with pandas' ``%f`` (nine
    digits) and ``%z``; blanks match any run of white space."""
    out, i = [], 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            d = fmt[i + 1]
            if d not in _DIRECTIVES:
                raise NotImplementedError(f"strptime directive %{d} ({VALUE_ITEM})")
            out.append(_DIRECTIVES[d])
            i += 2
            continue
        out.append(r"\s+" if c.isspace() else re.escape(c))
        while c.isspace() and i + 1 < len(fmt) and fmt[i + 1].isspace():
            i += 1
        i += 1
    return re.compile("".join(out), re.IGNORECASE)


def _format_is_iso(fmt: str) -> bool:
    """pandas' ``format_is_iso``: ``fmt`` starts an ISO 8601 format."""
    return fmt != "%Y%m" and any(
        f"%Y{d}%m{d}%d{t}%H:%M:%S{tail}".startswith(fmt)
        for d in (" ", "/", "\\", "-", ".", "") for t in (" ", "T")
        for tail in ("", "%z", ".%f", ".%f%z"))


def _iso_format_regex(fmt: str) -> re.Pattern:
    """The strings the ISO reader takes under an ISO ``fmt``
    (``compare_format``): a month or day of one digit only beside a
    separator, an hour, minute or second of one or two, any fraction, a
    zone ``Z`` or ``±h[h][[:]m[m]]``."""
    sep = bool(re.match(r"%Y[^%]", fmt))
    parts = {"%Y": r"\d{4}", "%m": r"\d{1,2}" if sep else r"\d{2}",
             "%d": r"\d{1,2}" if sep else r"\d{2}", "%H": r"\d{1,2}", "%M": r"\d{1,2}",
             "%S": r"\d{1,2}", "%f": r"\d*", "%z": r"(?:Z|[+-]\d{1,2}(?::?\d{1,2})?)"}
    return re.compile("".join(parts.get(tok, re.escape(tok))
                              for tok in re.findall(r"%.|[^%]", fmt)))


def _strptime_one(text: str, fmt: str) -> Optional[Stamp]:
    """One value as pandas' ``array_strptime`` reads it with ``fmt``,
    exactly (None: missing): an ISO ``fmt`` through the ISO reader, any
    other through Python's ``strptime`` patterns."""
    if text == "" or text in NAT_STRINGS:
        return None
    if _format_is_iso(fmt):
        stamp = _iso(text) if _iso_format_regex(fmt).fullmatch(text) else None
        if stamp is None:
            raise _Fail(f"time data {text!r} does not match format {fmt!r}")
        return stamp
    m = _format_regex(fmt).match(text)
    if m is None or m.end() != len(text):
        raise _Fail(f"time data {text!r} does not match format {fmt!r}")
    g = m.groupdict()
    year, month, day = int(g.get("Y") or 1900), 1, 1
    if g.get("m"):
        month = int(g["m"])
    for key, names in (("b", calendar.month_abbr), ("B", calendar.month_name)):
        if g.get(key):
            month = [n.lower() for n in names].index(g[key].lower())
    if g.get("d"):
        day = int(g["d"])
    hour = int(g.get("H") or 0)
    if g.get("I"):
        hour = int(g["I"]) % 12
        if (g.get("p") or "").lower() == "pm":
            hour += 12
    minute, second = int(g.get("M") or 0), int(g.get("S") or 0)
    frac = g.get("f") or ""
    padded = frac.ljust(9, "0")
    zone: Zone = None
    if g.get("z"):
        z = g["z"]
        if z == "Z":
            zone = "UTC"
        else:
            body = z[1:].replace(":", "")
            if len(body) > 4:
                raise NotImplementedError(f"{text!r}: a zone offset with seconds ({VALUE_ITEM})")
            off = (int(body[:2]) * 3600 + int(body[2:4]) * 60) * (-1 if z[0] == "-" else 1)
            zone = "UTC" if off == 0 else off
    if g.get("Z"):
        if g["Z"].lower() != "utc":
            raise NotImplementedError(f"{text!r}: the zone name {g['Z']!r} ({VALUE_ITEM})")
        zone = "UTC"
    try:
        wall = datetime.datetime(year, month, day, hour, minute, second, int(padded[:6]))
    except ValueError as e:
        raise _Fail(text) from e
    return Stamp(wall, int(padded[6:9]), zone, len(frac) > 6)


# --- to_datetime over a column ------------------------------------------------


#: The instants a ``datetime64[ns]`` holds (pandas' bounds at that unit).
_NS_RANGE = (datetime.datetime(1677, 9, 21, 0, 12, 44), datetime.datetime(2262, 4, 11, 23, 47, 16))


def _column(stamps: list[Optional[Stamp]]) -> list[Optional[Stamp]]:
    """One zone for the column, and nanosecond stamps within that unit's
    range, or the conversion fails."""
    present = [s for s in stamps if s is not None]
    if len({s.zone for s in present}) > 1:
        raise _Fail("mixed time zones")
    if any(s.ns_digits for s in present) and not all(
            _NS_RANGE[0] <= s.wall <= _NS_RANGE[1] for s in present):
        raise _Fail("out of bounds for nanoseconds")
    return stamps


def _with_format(values: list[Optional[str]], fmt: Optional[str]) -> list[Optional[Stamp]]:
    if fmt is None:
        return _column([None if v is None else _parse_one(v) for v in values])
    if fmt == "iso8601":
        out = []
        for v in values:
            if v is None or v == "" or v in NAT_STRINGS:
                out.append(None)
                continue
            stamp = _iso(v)
            if stamp is None:
                raise _Fail(f"{v!r} is no ISO 8601 date")
            out.append(stamp)
        return _column(out)
    return _column([None if v is None else _strptime_one(v, fmt) for v in values])


def parse_strings(values: list[Optional[str]]) -> Optional[list[Optional[Stamp]]]:
    """The stamps pandas' ``_try_convert_to_date`` gives a column of
    strings (None: missing), or None where it keeps the strings."""
    present = [v for v in values if v is not None and v != "" and v not in NAT_STRINGS
               and v not in _TODAY]
    first = present[0] if present else None
    guessed = guess_format(first) if first is not None else None
    for attempt in ("guess", "iso8601", "mixed"):
        try:
            if attempt == "guess":
                return _with_format(values, guessed)
            if attempt == "iso8601":
                return _with_format(values, "iso8601")
            return _with_format(values, None)
        except _Fail:
            continue
    return None


__all__ = ["NAT_STRINGS", "Stamp", "guess_format", "parse_strings"]
