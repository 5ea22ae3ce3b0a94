"""Multilingual LibriSpeech (MLS) transcripts → a TSV manifest (counterpart
of ``tensorflowasr_tpu/scripts/utils/create_mls_trans.py``): MLS ships
``transcripts.txt`` files of ``<utt_id>\\t<transcript>`` lines, utt_id =
``speaker_chapter_index``, with the audio at
``audio/<speaker>/<chapter>/<utt_id>.flac``; this walks a split directory
and writes the ``PATH\\tDURATION\\tTRANSCRIPT`` manifest.
"""

from __future__ import annotations

import argparse
import os

from tensorflowasr_tpu_torch.data import audio as audio_lib


def convert_split(split_dir: str, output: str | None = None) -> str:
    transcripts_file = os.path.join(split_dir, "transcripts.txt")
    if not os.path.exists(transcripts_file):
        raise FileNotFoundError(transcripts_file)
    output = output or os.path.join(split_dir, "transcripts.tsv")
    rows = []
    with open(transcripts_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt_id, transcript = line.split("\t", 1)
            speaker, chapter, _ = utt_id.split("_", 2)
            path = os.path.join(split_dir, "audio", speaker, chapter, f"{utt_id}.flac")
            if not os.path.exists(path):
                continue
            duration = len(audio_lib.read_audio(path)) / 16000.0
            rows.append(f"{path}\t{duration:.3f}\t{transcript}")
    with open(output, "w", encoding="utf-8") as f:
        f.write("PATH\tDURATION\tTRANSCRIPT\n")
        f.write("\n".join(rows) + "\n")
    return output


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split-dir", required=True, help="e.g. mls_english/train")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    print(convert_split(args.split_dir, args.output))
    return 0


if __name__ == "__main__":
    main()
