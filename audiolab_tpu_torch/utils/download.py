"""Media download handler (counterpart of audiolab_tpu/utils/download.py,
copied: framework-free host code; reference: handlers/download.py:47
``download_files`` via yt-dlp + direct URLs).

yt-dlp is optional: a URL that names a media file (and every URL where the
package is not importable) is fetched by urllib, any other URL through
yt-dlp when it is importable — the same call signature either way."""

from __future__ import annotations

import os
import urllib.request


def download_files(urls: list[str], out_dir: str, callback=None) -> list[str]:
    """Download each URL into ``out_dir``; returns local paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    try:
        import yt_dlp  # noqa: F401

        have_ytdlp = True
    except ImportError:
        have_ytdlp = False

    for i, url in enumerate(urls):
        if callback:
            callback(i, f"downloading {url}", len(urls))
        if have_ytdlp and not url.lower().endswith(
                (".wav", ".mp3", ".flac", ".ogg", ".mp4", ".m4a")):
            import yt_dlp

            opts = {"format": "bestaudio/best",
                    "outtmpl": os.path.join(out_dir, "%(title)s.%(ext)s"),
                    "quiet": True}
            with yt_dlp.YoutubeDL(opts) as ydl:
                info = ydl.extract_info(url, download=True)
                paths.append(ydl.prepare_filename(info))
        else:
            name = os.path.basename(url.split("?")[0]) or f"download_{i}"
            dst = os.path.join(out_dir, name)
            urllib.request.urlretrieve(url, dst)
            paths.append(dst)
    return paths
