"""DAW project export: Ableton Live .als and Reaper .rpp writers (counterpart
of audiolab_tpu/utils/daw.py, a copy of its host code so that both packages
write the same projects).

Reference behavior: handlers/ableton.py:17 (gzipped XML .als with one audio
track per stem), handlers/reaper.py:9 (reathon-built .rpp), wrappers/
export.py (BPM detect + zip).  Both formats are plain-text/XML; we emit them
directly with no template file or third-party lib.
"""

from __future__ import annotations

import gzip
import os
import zipfile
from xml.etree import ElementTree as ET

import numpy as np


def detect_bpm(audio: np.ndarray, sr: int) -> float:
    """Tempo via onset-strength autocorrelation (librosa.beat.tempo role,
    wrappers/export.py:18)."""
    x = np.asarray(audio, dtype=np.float32)
    if x.ndim == 2:
        x = x.mean(axis=0)
    hop = 512
    n = (len(x) // hop) * hop
    if n < hop * 8:
        return 120.0
    frames = x[:n].reshape(-1, hop)
    energy = (frames**2).sum(axis=1)
    onset = np.maximum(np.diff(energy), 0.0)
    if onset.std() < 1e-12:
        return 120.0
    onset = (onset - onset.mean()) / (onset.std() + 1e-9)
    ac = np.correlate(onset, onset, mode="full")[len(onset) - 1 :]
    fps = sr / hop
    lo, hi = int(fps * 60 / 200), int(fps * 60 / 60)  # 60-200 BPM lags
    if hi <= lo or hi >= len(ac):
        return 120.0
    lag = lo + int(np.argmax(ac[lo:hi]))
    return float(round(60.0 * fps / lag, 1))


def _video_crc_and_size(path: str) -> tuple[int, int]:
    """CRC32 + byte size of the video file (reference video_track.py
    OriginalFileSize/OriginalCrc fields), streamed so big files are fine."""
    import zlib

    crc = 0
    size = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def add_video_track(
    tracks: "ET.Element",
    video_file: str,
    track_id: int,
    bpm: float = 120.0,
    duration_s: float | None = None,
    color: int = 16,
) -> None:
    """Ableton video track (reference util/video_track.py:5): video rides
    an AudioTrack whose clip references the media file, with beat-timed
    clip start/end, its own color, and file-info placeholders."""
    crc, size = (0, 0)
    if os.path.exists(video_file):
        crc, size = _video_crc_and_size(video_file)
    clip_end = (duration_s or 0.0) * bpm / 60.0
    name = os.path.splitext(os.path.basename(video_file))[0]

    track = ET.SubElement(tracks, "AudioTrack", Id=str(track_id))
    tname = ET.SubElement(track, "Name")
    ET.SubElement(tname, "EffectiveName", Value=f"{track_id}-{name}")
    ET.SubElement(track, "Color", Value=str(color))
    dev = ET.SubElement(track, "DeviceChain")
    clip = ET.SubElement(dev, "AudioClip",
                         Id=str(track_id * 100), Time="0")
    ET.SubElement(clip, "CurrentStart", Value="0")
    ET.SubElement(clip, "CurrentEnd", Value=str(clip_end))
    ET.SubElement(clip, "Name", Value=name)
    sample = ET.SubElement(clip, "SampleRef")
    fref = ET.SubElement(sample, "FileRef")
    ET.SubElement(fref, "RelativePath",
                  Value=f"Samples/Imported/{os.path.basename(video_file)}")
    ET.SubElement(fref, "Path", Value=os.path.abspath(video_file))
    ET.SubElement(fref, "OriginalFileSize", Value=str(size))
    ET.SubElement(fref, "OriginalCrc", Value=str(crc))


def write_ableton_project(
    out_path: str,
    stems: list[str],
    bpm: float = 120.0,
    sample_rate: int = 44100,
    video_file: str | None = None,
    video_duration_s: float | None = None,
) -> str:
    """Minimal valid Live 11 set: one audio track per stem, master tempo,
    optional video track (util/video_track.py role)."""
    root = ET.Element(
        "Ableton",
        MajorVersion="5",
        MinorVersion="11.0_11202",
        Creator="audiolab_tpu",
        Revision="0",
    )
    live_set = ET.SubElement(root, "LiveSet")
    tracks = ET.SubElement(live_set, "Tracks")
    for i, stem in enumerate(stems):
        track = ET.SubElement(tracks, "AudioTrack", Id=str(10 + i))
        name = ET.SubElement(track, "Name")
        ET.SubElement(
            name, "EffectiveName", Value=os.path.splitext(os.path.basename(stem))[0]
        )
        dev = ET.SubElement(track, "DeviceChain")
        sample = ET.SubElement(dev, "SampleRef")
        fref = ET.SubElement(sample, "FileRef")
        ET.SubElement(fref, "Path", Value=os.path.abspath(stem))
    if video_file:
        add_video_track(tracks, video_file, 10 + len(stems), bpm,
                        video_duration_s)
    master = ET.SubElement(live_set, "MasterTrack")
    mixer = ET.SubElement(master, "DeviceChain")
    tempo = ET.SubElement(mixer, "Tempo")
    ET.SubElement(tempo, "Manual", Value=str(bpm))

    xml = ET.tostring(root, encoding="utf-8", xml_declaration=True)
    with gzip.open(out_path, "wb") as f:  # .als is gzipped XML
        f.write(xml)
    return out_path


def write_reaper_project(
    out_path: str,
    stems: list[str],
    bpm: float = 120.0,
    sample_rate: int = 44100,
    video_file: str | None = None,
) -> str:
    """Reaper .rpp: plain-text node tree, one track+item per stem; video
    gets its own track with a SOURCE VIDEO item."""
    lines = [
        "<REAPER_PROJECT 0.1 \"7.0\" 0",
        f"  TEMPO {bpm} 4 4",
        f"  SAMPLERATE {sample_rate} 0 0",
    ]

    def track(name: str, path: str, source: str) -> list[str]:
        return [
            "  <TRACK",
            f'    NAME "{name}"',
            "    <ITEM",
            "      POSITION 0",
            f'      NAME "{name}"',
            f"      <SOURCE {source}",
            f'        FILE "{os.path.abspath(path)}"',
            "      >",
            "    >",
            "  >",
        ]

    for stem in stems:
        name = os.path.splitext(os.path.basename(stem))[0]
        lines += track(name, stem, "WAVE")
    if video_file:
        lines += track(os.path.splitext(os.path.basename(video_file))[0],
                       video_file, "VIDEO")
    lines.append(">")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path


def zip_project(zip_path: str, files: list[str]) -> str:
    """Bundle project + stems (wrappers/export.py zips the project dir)."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for f in files:
            z.write(f, arcname=os.path.basename(f))
    return zip_path
